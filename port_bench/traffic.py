"""The one traffic generator: a mix is a data file under ``traffic/`` that
names the photos the clients send (count, size, faces and their sizes, the
wire format); every run makes them anew from ``--seed``. Each seed gives
photos of the same sizes and face counts, so the work per request is the
same from seed to seed; only the pixels differ.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from port_bench import inputs

FORMATS = ("rgb", "dct420s")


def make(mix: dict, seed: int) -> list[dict]:
    """[{"rgb": uint8 [H, W, 3], "dct": planes (dct420s only)}] of the mix."""
    if mix["format"] not in FORMATS:
        raise ValueError(f"unknown format {mix['format']!r}; expected one of {FORMATS}")
    hw = (mix["height"], mix["width"])

    def one(i: int) -> dict:
        rgb = inputs.photo(seed, i, hw, mix["faces"], tuple(mix["face_px"]))
        item = {"rgb": rgb}
        if mix["format"] == "dct420s":
            item["dct"] = inputs.encode_dct420(rgb)
        return item

    with ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(one, range(mix["photos"])))
