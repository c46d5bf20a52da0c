"""The comparison that decides ``correct``: every answer the timed path gave,
against the plain reference's answer for the same input.

Detections are paired one to one, greedily by IoU (at least 0.5). Every
detection that scores at least ``CONFIDENT`` on either side gets a gap: with
a partner, the largest of the score gap, the box gap (the largest corner
shift as a share of the reference box's longer side) and the keypoint gap
(the largest keypoint shift on the same scale, or the largest gap of a
keypoint's visibility score); without one, its own score (as if the partner
scored 0). A run is judged on quantiles of these gaps over all its answers,
which a missing, moved or misscored answer raises, and on the worst answer's
median gap over its detections, which one wrong answer among thousands
raises (answers of ``MIN_DETECTIONS`` confident detections or more). The rare
detection that the merge treats differently on the two sides (a member
crossing the match threshold changes a union box; another keeper brings
other keypoints) moves only the widest gaps, which ``Tally.widest`` gives
for setting limits and which are not judged. An enhanced image (the
enhance-first pipeline's) is compared pixel by pixel on the 0-255 scale.
"""
from __future__ import annotations

import numpy as np

CONFIDENT = 0.5
MIN_IOU = 0.5
# an answer's median gap is judged where it has this many confident
# detections, so that one the merge treats differently cannot set it
MIN_DETECTIONS = 5


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def pair(got: dict, want: dict) -> list[tuple[int, int]]:
    """One-to-one pairs (got row, want row), greedily by descending IoU."""
    if not len(got["boxes"]) or not len(want["boxes"]):
        return []
    m = iou(got["boxes"], want["boxes"])
    pairs, used_g, used_w = [], set(), set()
    for flat in np.argsort(-m, axis=None, kind="stable"):
        i, j = divmod(int(flat), m.shape[1])
        if m[i, j] < MIN_IOU:
            break
        if i not in used_g and j not in used_w:
            pairs.append((i, j))
            used_g.add(i)
            used_w.add(j)
    return pairs


class Tally:
    """Accumulates the numbers of a run over its answers."""

    def __init__(self):
        self.gaps: list[float] = []  # one per confident detection of either side
        self.worst = {k: 0.0 for k in (1, MIN_DETECTIONS)}  # the largest median gap of an answer of k+ detections
        self.widest = [0.0, 0.0, 0.0]  # score, box and keypoint gaps of the confident pairs
        self.unpaired = self.confident = 0
        self.sr_gap = None

    def detections(self, got: dict, want: dict) -> None:
        pairs = pair(got, want)
        gaps, per_detection = [], []
        for i, j in pairs:
            if max(got["scores"][i], want["scores"][j]) < CONFIDENT:
                continue
            wb = want["boxes"][j]
            side = max(wb[2] - wb[0], wb[3] - wb[1], 1e-6)
            kg, kw = got["kpts"][i], want["kpts"][j]
            parts = (float(abs(got["scores"][i] - want["scores"][j])),
                     float(np.abs(got["boxes"][i] - wb).max() / side),
                     max(float(np.abs(kg[:, :2] - kw[:, :2]).max() / side), float(np.abs(kg[:, 2] - kw[:, 2]).max())))
            self.widest = [max(a, b) for a, b in zip(self.widest, parts)]
            # a pair counts once for each side on which it is confident
            n = int(got["scores"][i] >= CONFIDENT) + int(want["scores"][j] >= CONFIDENT)
            gaps += [max(parts)] * n
            per_detection.append(max(parts))
        paired_g = {i for i, _ in pairs}
        paired_w = {j for _, j in pairs}
        for side, paired in ((got, paired_g), (want, paired_w)):
            for i, s in enumerate(side["scores"]):
                if s >= CONFIDENT:
                    self.confident += 1
                    if i not in paired:
                        self.unpaired += 1
                        gaps.append(float(s))
                        per_detection.append(float(s))
        for k in self.worst:
            if len(per_detection) >= k:
                self.worst[k] = max(self.worst[k], float(np.median(per_detection)))
        self.gaps += gaps

    def image(self, got: np.ndarray, want: np.ndarray) -> None:
        """uint8 images: the mean absolute gap in levels, widest over images."""
        gap = float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean()) if got.shape == want.shape else 255.0
        self.sr_gap = gap if self.sr_gap is None else max(self.sr_gap, gap)

    def numbers(self) -> dict[str, float]:
        """The numbers a run is judged on."""
        q = np.percentile(self.gaps, [50, 90]) if self.gaps else [1.0, 1.0]
        out = {"gap_p50": float(q[0]), "gap_p90": float(q[1]), "worst_answer_p50": self.worst[MIN_DETECTIONS]}
        if self.sr_gap is not None:
            out["sr_gap"] = self.sr_gap
        return out

    def spread(self) -> dict[str, float]:
        """The widest gaps and the unpaired share, read when limits are set."""
        return {"gap_p99": float(np.percentile(self.gaps, 99)) if self.gaps else 1.0, "score_gap": self.widest[0],
                "box_gap": self.widest[1], "kpt_gap": self.widest[2],
                "unpaired": self.unpaired / max(self.confident, 1), "worst_answer_p50.any": self.worst[1]}


def judge(numbers: dict[str, float], limits: dict[str, float], failed: int, attempted: int):
    """(correct, {name: {value, limit}}) over the numbers that have a limit."""
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    ok = attempted > 0 and failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                               for c in checks.values())
    return ok, checks


def sound(det: dict, h: int, w: int) -> bool:
    """A served answer is finite and its boxes lie inside the image."""
    if not all(np.isfinite(det[k]).all() for k in ("boxes", "scores", "kpts")):
        return False
    b = det["boxes"]
    return bool((b[:, 0::2] >= 0).all() and (b[:, 0::2] <= w).all() and (b[:, 1::2] >= 0).all()
                and (b[:, 1::2] <= h).all())
