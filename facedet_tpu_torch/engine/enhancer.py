"""FaceEnhancer: the Real-ESRGAN super-resolution engine of the port.

Counterpart of facedet_tpu/engine/enhancer.py. Tiling is static: the image
is reflect-padded to a tile grid with halo padding, the halo windows are
gathered into one ``[G, 3, T+2p, T+2p]`` batch (the CHW tile gather of
ops/kernels/tile_gather.py: a CUDA kernel on the card), the RRDB net runs
over the batch in chunks of ``max_tiles_per_batch`` windows, and the output
is assembled by a reshape. Small face crops are padded into size buckets, as
in the JAX package, so that both give the same pixels.

The public functions keep the JAX package's layout: images are ``[H,W,3]``
float tensors in [0, 1] (or uint8 arrays at the host edge). Inside, the
compute is CHW. Everything runs eagerly: there is no per-shape cache.

Device: ``device=None`` means ``"cuda"``; where there is no card the
constructor raises unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from facedet_tpu_torch.engine.detector import _exact_float32, resolve_device
from facedet_tpu_torch.models.rrdbnet import MODEL_CATALOG, RRDBConfig, RRDBNet, init_rrdbnet_
from facedet_tpu_torch.ops.image import reflect_pad, resize_chw
from facedet_tpu_torch.ops.kernels.tile_gather import gather_tiles_chw

__all__ = [
    "FaceEnhancer",
    "plan_tile_grid",
    "tiled_sr",
    "enhance_face_crops_batch",
    "create_enhancement_summary",
    "get_available_models",
]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_tile_grid(
    h: int,
    w: int,
    tile: int = 400,
    tile_pad: int = 10,
    max_tiles_per_batch: int = 8,
) -> tuple[int, int, int, int]:
    """Choose a per-axis halo-tile grid (gh, gw, tile_h, tile_w) minimising
    computed pixels for an [h, w] image.

    The budget is ``max_tiles_per_batch * (tile + 2*tile_pad)^2`` pixels per
    net call; the planner picks the fewest and cheapest per-axis tiles whose
    windows fit it, so an image that fits runs as ONE window with no halo.
    Copied from the JAX package, budget included, so that both cut an image
    into the same tiles and their results compare tile for tile.

    Tile dims are rounded up to multiples of 8 (which also keeps halo windows
    even for the x2 net's pixel-unshuffle)."""
    budget = max_tiles_per_batch * (tile + 2 * tile_pad) ** 2
    best = None
    gh_max = max(1, -(-h // 64))
    gw_max = max(1, -(-w // 64))
    for gh in range(1, gh_max + 1):
        th = h if gh == 1 else _ceil_to(-(-h // gh), 8)
        win_h = th + (2 * tile_pad if gh > 1 else 0)
        for gw in range(1, gw_max + 1):
            tw = w if gw == 1 else _ceil_to(-(-w // gw), 8)
            win_w = tw + (2 * tile_pad if gw > 1 else 0)
            g = gh * gw
            chunk = min(max_tiles_per_batch, g)
            if chunk * win_h * win_w > budget:
                continue
            n_chunks = -(-g // chunk)
            cost = n_chunks * chunk * win_h * win_w  # incl. chunk-pad tiles
            key = (cost, g, abs(win_h - win_w))
            if best is None or key < best[0]:
                best = (key, (gh, gw, th, tw))
    if best is None:  # budget smaller than any window: legacy square grid
        return -(-h // tile), -(-w // tile), tile, tile
    return best[1]


def _tiled_sr_chw(
    fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    scale: int,
    tile: int,
    tile_pad: int,
    max_tiles_per_batch: int,
) -> torch.Tensor:
    """``tiled_sr`` in the compute layout: ``fn`` maps [B,3,h,w] to
    [B,3,h*scale,w*scale]; ``image`` is [3,H,W]."""
    h, w = image.shape[1], image.shape[2]
    if tile <= 0:
        return fn(image[None])[0]
    gh, gw, th, tw = plan_tile_grid(h, w, tile, tile_pad, max_tiles_per_batch)
    if gh == 1 and gw == 1 and th == h and tw == w:
        return fn(image[None])[0]
    ph_pad = tile_pad if gh > 1 else 0
    pw_pad = tile_pad if gw > 1 else 0
    ph, pw = gh * th, gw * tw
    padded = reflect_pad(image, {1: (ph_pad, ph - h + ph_pad), 2: (pw_pad, pw - w + pw_pad)}).contiguous()
    win_h, win_w = th + 2 * ph_pad, tw + 2 * pw_pad
    offs = [(i * th, j * tw) for i in range(gh) for j in range(gw)]
    tiles = gather_tiles_chw(padded, offs, win_h, win_w)  # [G,3,win_h,win_w]
    chunk = min(max_tiles_per_batch, len(offs))
    out = torch.cat([fn(tiles[i : i + chunk]) for i in range(0, len(offs), chunk)])
    py, px = ph_pad * scale, pw_pad * scale
    core = out[:, :, py : py + th * scale, px : px + tw * scale]
    core = core.reshape(gh, gw, 3, th * scale, tw * scale)
    full = core.permute(2, 0, 3, 1, 4).reshape(3, ph * scale, pw * scale)
    return full[:, : h * scale, : w * scale]


def tiled_sr(
    fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    scale: int,
    tile: int = 400,
    tile_pad: int = 10,
    max_tiles_per_batch: int = 8,
) -> torch.Tensor:
    """Run SR function ``fn`` ([B,h,w,3] -> [B,h*scale,w*scale,3]) over a
    halo-padded static tile grid of ``image`` [H,W,3]; returns
    [H*scale, W*scale, 3].

    The grid comes from :func:`plan_tile_grid`: the fewest per-axis tiles
    whose halo windows fit the per-call pixel budget (the whole image when it
    fits). The windows go through ``fn`` in chunks of ``max_tiles_per_batch``,
    which bounds the activation memory; the last chunk may be shorter."""
    out = _tiled_sr_chw(
        lambda x: fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2),
        image.permute(2, 0, 1).contiguous(), scale, tile, tile_pad, max_tiles_per_batch,
    )
    return out.permute(1, 2, 0)


_SIZE_BUCKETS = (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)

# Golden-trained weights of the JAX package (its tools/sr_golden_train.py),
# picked up by catalog name when no explicit model_path is given.
_GOLDEN_CKPTS = {
    "RealESRGAN_x4plus": "rrdb_x4gan_golden.npz",
    "RealESRGAN_x2plus": "rrdb_x2_golden.npz",
    "RealESRGAN_x4cascade": "rrdb_x2_golden.npz",
}

# Names that run the x2 net TWICE for a 4x output instead of a single-pass
# x4 net: a second restoration pass instead of a resize.
_CASCADE_ALIASES = {"RealESRGAN_x4cascade": "RealESRGAN_x2plus"}


def _golden_ckpt_path(model_name: str) -> Optional[str]:
    fname = _GOLDEN_CKPTS.get(model_name)
    if fname is None:
        return None
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, "facedet_tpu", "eval", "assets", fname)
    return path if os.path.exists(path) else None


def _bucket_dim(x: int) -> int:
    for b in _SIZE_BUCKETS:
        if x <= b:
            return b
    return _ceil_to(x, 512)


class FaceEnhancer:
    """Real-ESRGAN enhancer.

    model_name ∈ MODEL_CATALOG (or a cascade alias); ``half=True`` selects
    bfloat16 compute. ``model_path`` loads a ``.npz`` checkpoint of the JAX
    package; None resolves the committed golden-trained weights for catalog
    names (random init from ``generator`` when absent or when ``cfg`` is
    custom). On the CPU the compute is float32 and ``tile`` is at most 200,
    as in the JAX class.
    """

    def __init__(
        self,
        model_name: str = "RealESRGAN_x4plus",
        model_path: Optional[str] = None,
        outscale: float = 4.0,
        tile: int = 400,
        tile_pad: int = 10,
        half: bool = True,
        device=None,
        cfg: Optional[RRDBConfig] = None,
        max_tiles_per_batch: int = 8,
        cascade: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        if model_name in _CASCADE_ALIASES:
            cascade = True
        if cfg is None:
            catalog_name = _CASCADE_ALIASES.get(model_name, model_name)
            if catalog_name not in MODEL_CATALOG:
                raise ValueError(
                    f"unknown model {model_name!r}; available: "
                    f"{list(MODEL_CATALOG) + list(_CASCADE_ALIASES)}"
                )
            cfg = MODEL_CATALOG[catalog_name]
            if model_path is None:
                model_path = _golden_ckpt_path(model_name)
                if model_path:
                    print(f"[enhancer] golden-trained weights: {os.path.basename(model_path)}")
        self.device = resolve_device(device)
        if self.device.type == "cpu":
            half = False
            if tile > 200:
                tile = 200
        if half:
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
        self.cfg = cfg
        self.model_name = model_name
        self.cascade = bool(cascade)
        self.outscale = float(outscale)
        self.tile = tile
        self.tile_pad = tile_pad
        self.max_tiles_per_batch = max_tiles_per_batch
        model = RRDBNet(cfg)
        if model_path is None:
            init_rrdbnet_(model, generator if generator is not None else torch.Generator().manual_seed(0))
        else:
            from facedet_tpu_torch.models.from_jax import load_rrdb_npz

            load_rrdb_npz(model, model_path)
        self.model = model.set_dtypes().to(self.device).eval()
        if self.device.type == "cuda":
            # cuDNN's tensor-core convs take NHWC: keep weights and
            # activations in that memory format, so no conv transposes
            self.model = self.model.to(memory_format=torch.channels_last)
        self.stats = {"images": 0, "seconds": 0.0}
        # what the last enhance_to_jpeg call did: the branch it took, the
        # clip and nonzero counts, and the bytes it fetched from the device
        self.last_fetch: dict = {}

    def _net(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,h,w] -> [B,3,h*s,w*s] float32, clipped to [0, 1]."""
        with torch.inference_mode(), _exact_float32(self.cfg.dtype == "float32"):
            x = x.to(self.device, self.cfg.compute_dtype)
            if x.is_cuda:
                x = x.contiguous(memory_format=torch.channels_last)
            return self.model.forward_nchw(x).clamp_(0.0, 1.0)

    def _net_chunked(self, x: torch.Tensor) -> torch.Tensor:
        """``_net`` over a batch of equal crops, as many per call as the tile
        plan's pixel budget allows."""
        budget = self.max_tiles_per_batch * (max(self.tile, 1) + 2 * self.tile_pad) ** 2
        chunk = max(1, budget // (x.shape[2] * x.shape[3]))
        if x.shape[0] <= chunk:
            return self._net(x)
        return torch.cat([self._net(x[i : i + chunk]) for i in range(0, x.shape[0], chunk)])

    def _n_passes(self, outscale: float) -> int:
        s = self.cfg.scale
        return 2 if (self.cascade and s > 1 and outscale >= s * s - 1e-6) else 1

    def _enhance_chw(self, image: torch.Tensor, outscale: float) -> torch.Tensor:
        """[3,H,W] float in [0,1] on the device -> [3,H',W'] float32."""
        h, w = image.shape[1], image.shape[2]
        s = self.cfg.scale
        m = 2 if s == 2 else (4 if s == 1 else 1)
        n_passes = self._n_passes(outscale)
        s_eff = s**n_passes
        with torch.inference_mode():
            img = image.to(torch.float32)
            if h % m or w % m:  # pixel-unshuffle divisibility
                img = reflect_pad(img, {1: (0, (-h) % m), 2: (0, (-w) % m)})
            args = (s, self.tile, self.tile_pad, self.max_tiles_per_batch)
            out = _tiled_sr_chw(self._net, img.contiguous(), *args)[:, : h * s, : w * s]
            if n_passes == 2:
                out = _tiled_sr_chw(self._net, out.contiguous(), *args)[:, : h * s_eff, : w * s_eff]
            if abs(outscale - s_eff) > 1e-6:
                th, tw = int(round(h * outscale)), int(round(w * outscale))
                out = resize_chw(out, th, tw, "lanczos3").clamp_(0.0, 1.0)
            return out

    def enhance_array(self, image: torch.Tensor, outscale: Optional[float] = None) -> torch.Tensor:
        """Device path: [H,W,3] float in [0,1] -> enhanced [H',W',3] float32
        tensor on the enhancer's device (a view of the CHW result)."""
        outscale = self.outscale if outscale is None else float(outscale)
        image = torch.as_tensor(image).to(self.device)
        return self._enhance_chw(image.permute(2, 0, 1), outscale).permute(1, 2, 0)

    def enhance_image(self, image: np.ndarray, outscale: Optional[float] = None) -> tuple[np.ndarray, float]:
        """Host path: uint8 HWC in -> (uint8 HWC out, elapsed seconds)."""
        t0 = time.perf_counter()
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if img.shape[-1] == 4:
            img = img[..., :3]
        out = self.enhance_array(image_to_device(img, self.device), outscale)
        # quantise ON THE DEVICE: the x4 output holds 16x the input pixels,
        # and float32 would move 4x the bytes of the uint8 result
        out8 = _to_uint8(out).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["images"] += 1
        self.stats["seconds"] += dt
        return out8, dt

    def enhance_detections(self, image: torch.Tensor, detections, crop_size: int = 128,
                           margin: float = 0.1) -> torch.Tensor:
        """Detect -> crop -> enhance without files: cut every detection's box
        from the image on the device (ops/crop_resize.py), batch them at
        ``crop_size``, and run the SR net over the batch.

        Returns [N, crop_size*scale, crop_size*scale, 3] enhanced crops (rows
        for invalid detections are garbage: mask with ``detections.valid``).
        """
        from facedet_tpu_torch.ops.crop_resize import crop_and_resize_chw

        image = torch.as_tensor(image).to(self.device)
        crops = crop_and_resize_chw(image.permute(2, 0, 1), detections.boxes, crop_size, margin)
        out = self._net_chunked(crops)
        if self.cascade:  # cascade arm: crops at scale^2 via a second pass
            out = self._net_chunked(out)
        return out.permute(0, 2, 3, 1)

    def _load_bucketed(self, input_path: str):
        """File -> (float image [bh,bw,3] on the device, reflect-padded to
        the size bucket, true (h, w)): the shared preamble of both fetch
        paths, so that bucketing and padding cannot diverge between them."""
        from facedet_tpu_torch.utils.viz import load_image

        img = load_image(input_path)
        h, w = img.shape[:2]
        bh, bw = _bucket_dim(h), _bucket_dim(w)
        x = image_to_device(img, self.device)
        if (bh, bw) != (h, w):
            x = reflect_pad(x, {0: (0, bh - h), 1: (0, bw - w)})
        return x, h, w

    def enhance_face_crop(self, input_path: str, output_path: str, outscale: Optional[float] = None,
                          jpeg_quality: int = 95) -> bool:
        """File -> file crop enhancement, with size-bucket padding."""
        from facedet_tpu_torch.utils.viz import save_image

        x, h, w = self._load_bucketed(input_path)
        out = self.enhance_array(x, outscale)
        sc = self.outscale if outscale is None else outscale
        out = out[: int(round(h * sc)), : int(round(w * sc))]
        save_image(output_path, _to_uint8(out).cpu().numpy(), quality=jpeg_quality)
        return True

    def _enhance_dct_pipeline(self, h: int, w: int, outscale: float, quality: int, sparse: bool = False):
        """SR and the JPEG-domain encode on the device: the output (a x4
        result holds 16x the input pixels, so the fetch and not the upload
        is the large transfer) comes back as quantized DCT coefficient
        planes in wire layout (ops/jpeg_dct.py::encode_dct420_device)
        instead of raw RGB. The host entropy-codes them straight into a .jpg
        (native jpeg_write_coefficients): no DCT and no pixels on the host.

        ``sparse=True`` also packs the AC planes on the device into a
        presence bitmap and a value array capped at 25% density
        (ops/jpeg_dct.py::pack_sparse_bitmap_device), the fetch mirror of
        the dct420s ingest wire; the returned nnz tells the caller whether
        the cap held.

        Returns (pipeline, qy, qc, (th, tw)); ``pipeline(image)`` takes the
        [h,w,3] device image."""
        from facedet_tpu_torch.ops.jpeg_dct import encode_dct420_device, pack_sparse_bitmap_device, quality_tables

        qy, qc = quality_tables(quality)
        th = int(round(h * outscale))
        tw = int(round(w * outscale))
        ph, pw = -(-th // 16) * 16, -(-tw // 16) * 16
        # sparse-fetch value capacity: 25% density; an nnz above it falls
        # back to the dense fetch
        total_ac = 64 * (ph // 8) * (pw // 8) + 2 * 64 * (ph // 16) * (pw // 16)
        cap = ((total_ac // 4) + 7) & ~7

        def pipeline(image: torch.Tensor):
            with torch.inference_mode():
                out = self._enhance_chw(image.permute(2, 0, 1), outscale)
                out = torch.nn.functional.pad(out[None], (0, pw - tw, 0, ph - th), mode="replicate")[0]
                # wide (int16) AC wire: sharpened SR output exceeds the int8
                # range in some blocks, which would send every such image
                # through the pixel fetch
                planes = encode_dct420_device(out.permute(1, 2, 0), qy, qc, wide_ac=True)
                if not sparse:
                    return planes
                y_dc, y_ac, uv_dc, uv_ac, n_clipped = planes
                flat = torch.cat([y_ac.reshape(-1), uv_ac.reshape(-1)])
                bitmap, vals, nnz = pack_sparse_bitmap_device(flat, cap)
                return y_dc, uv_dc, bitmap, vals, nnz, n_clipped

        return pipeline, qy, qc, (th, tw)

    def enhance_to_jpeg(self, input_path: str, output_path: str, outscale: Optional[float] = None,
                        quality: int = 95, sparse: bool = False) -> bool:
        """File -> enhanced .jpg with the output fetched as quantized DCT
        coefficients and entropy-coded natively (see _enhance_dct_pipeline).
        Same size-bucketing and default JPEG quality as
        :meth:`enhance_face_crop`, so the fetch format is a pure transport
        choice. Outputs whose quantized AC exceeds the wire range fall back
        to the pixel fetch rather than shipping clipped coefficients.
        ``sparse=True`` downloads the AC planes as a bitmap + packed values;
        density above the 25% cap falls back to the dense fetch. Where the
        native writer is unavailable the fetched planes are decoded on the
        host and saved as pixels. ``self.last_fetch`` says which of these
        happened."""
        from facedet_tpu_torch.data.native_loader import save_dct420_jpeg
        from facedet_tpu_torch.ops.jpeg_dct import unpack_sparse_bitmap_np, wire_planes_to_dct_image

        x, h, w = self._load_bucketed(input_path)
        bh, bw = int(x.shape[0]), int(x.shape[1])
        sc = self.outscale if outscale is None else float(outscale)
        pipeline, qy, qc, _bucket_thw = self._enhance_dct_pipeline(bh, bw, sc, quality, sparse=sparse)
        th, tw = int(round(h * sc)), int(round(w * sc))
        info = {"sparse": bool(sparse)}
        if sparse:
            y_dc, uv_dc, bitmap, vals, nnz, n_clipped = pipeline(x)
            info.update(n_clipped=int(n_clipped), nnz=int(nnz), cap=int(vals.shape[0]))
            if info["n_clipped"] > 0:
                ok = self.enhance_face_crop(input_path, output_path, outscale, jpeg_quality=quality)
                self.last_fetch = {**info, "branch": "pixels (clipped coefficients)"}
                return ok
            if info["nnz"] > info["cap"]:  # density above the cap: dense fetch
                ok = self.enhance_to_jpeg(input_path, output_path, outscale, quality, sparse=False)
                self.last_fetch["sparse_overflow"] = {"nnz": info["nnz"], "cap": info["cap"]}
                return ok
            yb_h, yb_w = y_dc.shape
            cb_h, cb_w = uv_dc.shape[:2]
            ny = 64 * yb_h * yb_w
            fetched = [t.cpu() for t in (y_dc, uv_dc, bitmap, vals)]
            flat = unpack_sparse_bitmap_np(fetched[2], fetched[3], ny + 2 * 64 * cb_h * cb_w)
            planes = (
                fetched[0].numpy(),
                flat[:ny].reshape(64, yb_h, yb_w),
                fetched[1].numpy(),
                flat[ny:].reshape(2, 64, cb_h, cb_w),
            )
        else:
            *planes, n_clipped = pipeline(x)
            info.update(n_clipped=int(n_clipped))
            if info["n_clipped"] > 0:
                ok = self.enhance_face_crop(input_path, output_path, outscale, jpeg_quality=quality)
                self.last_fetch = {**info, "branch": "pixels (clipped coefficients)"}
                return ok
            fetched = [t.cpu() for t in planes]
            planes = tuple(t.numpy() for t in fetched)
        info["bytes_fetched"] = sum(t.numel() * t.element_size() for t in fetched)
        d = wire_planes_to_dct_image(planes, qy, qc, (th, tw))
        if save_dct420_jpeg(output_path, d):
            self.last_fetch = {**info, "branch": "coefficients, entropy-coded natively"}
            return True
        # no native lib: decode the fetched planes on host and save pixels
        from facedet_tpu_torch.engine.predict import _display_image
        from facedet_tpu_torch.utils.viz import save_image

        save_image(output_path, _display_image(d), quality=quality)
        self.last_fetch = {**info, "branch": "coefficients, decoded on the host (no native writer)"}
        return True

    def get_model_info(self) -> dict:
        n_params = sum(p.numel() for p in self.model.parameters())
        return {
            "model_name": self.model_name,
            "scale": self.cfg.scale ** (2 if self.cascade else 1),
            "net_scale": self.cfg.scale,
            "cascade": self.cascade,
            "outscale": self.outscale,
            "num_block": self.cfg.num_block,
            "num_feat": self.cfg.num_feat,
            "tile": self.tile,
            "tile_pad": self.tile_pad,
            "dtype": self.cfg.dtype,
            "num_params": n_params,
        }


def image_to_device(img: np.ndarray, device) -> torch.Tensor:
    """A host image [H,W,3] -> a tensor on ``device``; uint8 becomes float32
    in [0, 1] there (a quarter of the bytes cross). The array is copied
    first: PIL hands out read-only arrays, which torch will not wrap."""
    x = torch.tensor(np.asarray(img)).to(device)
    return x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Float in [0, 1] -> uint8, rounding half to even as ``jnp.round``."""
    return (x * 255.0).round().to(torch.uint8).contiguous()


def get_available_models() -> dict[str, dict]:
    out = {
        name: {"scale": cfg.scale, "num_block": cfg.num_block}
        for name, cfg in MODEL_CATALOG.items()
    }
    for alias, base in _CASCADE_ALIASES.items():
        cfg = MODEL_CATALOG[base]
        out[alias] = {
            "scale": cfg.scale * cfg.scale,
            "num_block": cfg.num_block,
            "cascade": True,
        }
    return out


def enhance_face_crops_batch(
    input_dir: str,
    output_dir: str,
    enhancer: FaceEnhancer,
    outscale: Optional[float] = None,
    max_retries: int = 2,
    fetch: str = "rgb",
) -> dict:
    """Iterate a crops directory, enhance each crop file with per-file retry,
    return a stats dict.

    ``fetch="dct420"`` downloads each result as device-encoded DCT
    coefficients and entropy-codes them natively into the output .jpg
    (enhance_to_jpeg), ``"dct420s"`` the same coefficients packed sparse;
    non-.jpg outputs keep the pixel path."""
    os.makedirs(output_dir, exist_ok=True)
    files = sorted(
        f
        for f in os.listdir(input_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
    )
    stats = {
        "total": len(files),
        "enhanced": 0,
        "failed": 0,
        "failed_files": [],
        "seconds": 0.0,
    }
    t0 = time.perf_counter()
    for fname in files:
        src = os.path.join(input_dir, fname)
        dst = os.path.join(output_dir, fname)
        ok = False
        use_dct = fetch in ("dct420", "dct420s") and dst.lower().endswith((".jpg", ".jpeg"))
        for _ in range(max_retries):
            try:
                if use_dct:
                    enhancer.enhance_to_jpeg(src, dst, outscale, sparse=fetch == "dct420s")
                else:
                    enhancer.enhance_face_crop(src, dst, outscale)
                ok = True
                break
            except Exception:  # per-file resilience, as the JAX package
                continue
        if ok:
            stats["enhanced"] += 1
        else:
            stats["failed"] += 1
            stats["failed_files"].append(fname)
    stats["seconds"] = time.perf_counter() - t0
    return stats


def create_enhancement_summary(
    stats: dict, output_path: Optional[str] = None, model_info: Optional[dict] = None
) -> str:
    """Text report."""
    lines = [
        "ENHANCEMENT SUMMARY",
        "=" * 40,
        f"Total crops: {stats.get('total', 0)}",
        f"Enhanced: {stats.get('enhanced', 0)}",
        f"Failed: {stats.get('failed', 0)}",
        f"Elapsed: {stats.get('seconds', 0.0):.2f}s",
    ]
    if stats.get("failed_files"):
        lines.append("Failed files: " + ", ".join(stats["failed_files"]))
    if model_info:
        lines.append("")
        lines.append("Model:")
        for k, v in model_info.items():
            lines.append(f"  {k}: {v}")
    report = "\n".join(lines)
    if output_path:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
        with open(output_path, "w") as f:
            f.write(report)
    return report
