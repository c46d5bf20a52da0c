"""Model FLOPs of RT-DETR-l from shapes, two per multiply-add of every
convolution, linear and attention product, for the per-layer ``mfu``
metrics of a configuration of the ``rtdetr`` family.

``rtdetr_l_parts`` walks the published layout (Ultralytics ``rtdetr-l.yaml``:
HGNetv2-L, the hybrid encoder, ``RTDETRDecoder`` at evaluation) at an
``h`` x ``w`` input (sides multiples of 32): the convolutions (the
backbone, the neck, ``input_proj``), the linears (AIFI, ``enc_output`` and
the encoder heads over every token, the query-position MLP, attention
projections, deformable ``value_proj`` over every token, offsets, weights,
FFNs, box MLPs in every layer, the last layer's score head), the attention
products (``q k^T`` and ``attn v`` of AIFI and of each decoder layer) and
the deformable sampling (four multiply-adds a channel to interpolate a
sample, one to weight it). No bias, normalisation or activation is counted.
``port_bench/tests`` and the CPU tests check it against a count of the
reference's own calls.
"""
from __future__ import annotations

LEVELS = 3


def rtdetr_l_parts(h: int, w: int, num_classes: int = 1, stem=(32, 48), stage_mid=(48, 96, 192, 384),
                   stage_out=(128, 512, 1024, 2048), block_layers: int = 6, hidden_dim: int = 256,
                   ffn_dim: int = 1024, repc3_depth: int = 3, num_decoder_layers: int = 6, num_heads: int = 8,
                   num_points: int = 4, num_queries: int = 300) -> dict[str, float]:
    """FLOPs of one forward by kind: ``conv``, ``linear``, ``attention``,
    ``sampling``."""
    macs = {"conv": 0, "linear": 0, "attention": 0, "sampling": 0}

    def conv(stride, cin, cout, k=1, groups=1):
        macs["conv"] += (h // stride) * (w // stride) * cout * (cin // groups) * k * k

    def linear(n, cin, cout):
        macs["linear"] += n * cin * cout

    cm, c2 = stem
    conv(2, 3, cm, 3)
    conv(2, cm, cm // 2, 2)
    conv(2, cm // 2, cm, 2)
    conv(4, 2 * cm, cm, 3)
    conv(4, cm, c2, 1)
    cin, stride = c2, 4
    for stage, blocks in enumerate((1, 1, 3, 1)):
        mid, cout, k, light = stage_mid[stage], stage_out[stage], (3, 3, 5, 5)[stage], stage >= 2
        if stage:
            stride *= 2
            conv(stride, cin, cin, 3, groups=cin)
        for _ in range(blocks):
            c = cin
            for _ in range(block_layers):
                if light:
                    conv(stride, c, mid, 1)
                    conv(stride, mid, mid, k, groups=mid)
                else:
                    conv(stride, c, mid, k)
                c = mid
            conv(stride, cin + block_layers * mid, cout // 2, 1)
            conv(stride, cout // 2, cout, 1)
            cin = cout
    d = hidden_dim

    def repc3(s):
        conv(s, 2 * d, d)
        conv(s, 2 * d, d)
        for _ in range(repc3_depth):
            conv(s, d, d, 3)
            conv(s, d, d, 1)

    n5 = (h // 32) * (w // 32)
    conv(32, stage_out[3], d)
    linear(n5, d, 3 * d)  # AIFI
    linear(n5, d, d)
    macs["attention"] += 2 * n5 * n5 * d
    linear(n5, d, ffn_dim)
    linear(n5, ffn_dim, d)
    conv(32, d, d)
    conv(16, stage_out[2], d)
    repc3(16)
    conv(16, d, d)
    conv(8, stage_out[1], d)
    repc3(8)
    conv(16, d, d, 3)
    repc3(16)
    conv(32, d, d, 3)
    repc3(32)
    # decoder
    tokens = sum((h // s) * (w // s) for s in (8, 16, 32))
    q = num_queries
    for s in (8, 16, 32):
        conv(s, d, d)
    linear(tokens, d, d)  # enc_output
    linear(tokens, d, num_classes)  # enc_score_head
    linear(q, d, d)  # enc_bbox_head
    linear(q, d, d)
    linear(q, d, 4)
    samples = num_heads * LEVELS * num_points
    for _ in range(num_decoder_layers):
        linear(q, 4, 2 * d)  # query_pos_head
        linear(q, 2 * d, d)
        linear(q, d, 3 * d)  # self-attention
        macs["attention"] += 2 * q * q * d
        linear(q, d, d)
        linear(tokens, d, d)  # value_proj
        linear(q, d, 2 * samples)
        linear(q, d, samples)
        macs["sampling"] += q * samples * (d // num_heads) * 5
        linear(q, d, d)  # output_proj
        linear(q, d, ffn_dim)
        linear(q, ffn_dim, d)
        linear(q, d, d)  # box MLP
        linear(q, d, d)
        linear(q, d, 4)
    linear(q, d, num_classes)  # the last layer's score head
    return {k: 2.0 * v for k, v in macs.items()}


def rtdetr_l_flops(h: int, w: int, num_classes: int = 1) -> float:
    """FLOPs of one forward of the published RT-DETR-l at ``h`` x ``w``."""
    return sum(rtdetr_l_parts(h, w, num_classes).values())
