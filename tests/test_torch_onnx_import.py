"""The port's ONNX importer (models/onnx_import.py) against the JAX
package's on the CPU: every case exports a torch module with the legacy
TorchScript serializer (it writes the protobuf in C++, so it needs no
``onnx`` package), then runs the same file through both importers on the
same seeded input. Ops that an export does not reach are held on graphs
built by hand from the parser's dataclasses.

Tolerance: every output within atol 1e-4 / rtol 1e-4 of the JAX importer's
(and of torch's own forward); integer outputs equal. The parsed
``OnnxGraph``s are equal field by field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from facedet_tpu.models import onnx_import as jax_onnx
from facedet_tpu_torch.models import onnx_import as t_onnx
from test_onnx_import import MicroScrfd, export_onnx

torch.set_num_threads(1)


def both(path, *inputs, atol=1e-4):
    """Run ``path`` through both importers; returns the port's outputs
    (numpy) after holding them against the JAX importer's."""
    jm, tm = jax_onnx.import_onnx(path), t_onnx.import_onnx(path)
    assert set(tm.params) == set(jm.params) and set(tm.constants) == set(jm.constants)
    assert tm.input_names == jm.input_names and tm.output_names == jm.output_names
    assert tm.input_hw() == jm.input_hw()
    want = jm(jm.params, *inputs)
    got = tm(tm.params, *inputs)
    assert len(got) == len(want)
    outs = []
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer) or w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)
        outs.append(g)
    return outs


def roundtrip(module, x, tmp_path, opset=11):
    path = str(tmp_path / "m.onnx")
    export_onnx(module, torch.as_tensor(x), path, opset=opset)
    with torch.no_grad():
        ref = module(torch.as_tensor(x))
    refs = [r.numpy() for r in (ref if isinstance(ref, (tuple, list)) else [ref])]
    outs = both(path, x)
    for got, want in zip(outs, refs):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    return path


def test_conv_bn_relu_sigmoid(tmp_path):
    class Tiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(3, 8, 3, stride=2, padding=1)
            self.bn = nn.BatchNorm2d(8)
            self.c2 = nn.Conv2d(8, 4, 1)

        def forward(self, x):
            return torch.sigmoid(self.c2(torch.relu(self.bn(self.c1(x)))))

    torch.manual_seed(0)
    m = Tiny()
    m.bn.running_mean.normal_()
    m.bn.running_var.uniform_(0.5, 2.0)
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32), np.float32)
    path = roundtrip(m, x, tmp_path)
    mod = t_onnx.import_onnx(path)
    assert mod.params and all(isinstance(v, np.ndarray) for v in mod.params.values())
    on_cpu = mod.params_on("cpu")
    assert all(isinstance(v, torch.Tensor) for v in on_cpu.values())
    assert torch.equal(mod(on_cpu, torch.from_numpy(x))[0], mod(mod.params, x)[0])


def test_residual_pool_gemm(tmp_path):
    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2d(3, 8, 3, padding=1)
            self.c2 = nn.Conv2d(8, 8, 3, padding=1)
            self.pool = nn.MaxPool2d(2, 2)
            self.fc = nn.Linear(8 * 8 * 8, 5)

        def forward(self, x):
            y = torch.relu(self.c1(x))
            y = torch.relu(self.c2(y) + y)
            y = self.pool(y)
            return self.fc(torch.flatten(y, 1))

    torch.manual_seed(1)
    x = np.random.default_rng(1).standard_normal((1, 3, 16, 16), np.float32)
    roundtrip(Net(), x, tmp_path)


def test_depthwise_and_leaky(tmp_path):
    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.dw = nn.Conv2d(6, 6, 3, padding=1, groups=6)
            self.pw = nn.Conv2d(6, 4, 1)
            self.act = nn.LeakyReLU(0.1)

        def forward(self, x):
            return self.act(self.pw(self.dw(x)))

    torch.manual_seed(2)
    x = np.random.default_rng(2).standard_normal((1, 6, 12, 12), np.float32)
    roundtrip(Net(), x, tmp_path)


def test_padded_pools_prelu_clip_and_split(tmp_path):
    """MaxPool pads with -inf, AveragePool divides by the count of real
    elements, PRelu per channel, Clip, Split, Softmax, ReduceMean."""

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.c = nn.Conv2d(4, 6, 3, padding=1)
            self.act = nn.PReLU(6)
            self.mp = nn.MaxPool2d(3, 2, padding=1)
            self.ap = nn.AvgPool2d(3, 2, padding=1, count_include_pad=False)

        def forward(self, x):
            y = self.act(self.c(x)) - 5.0  # negative values: a zero pad would win the max
            a, b = torch.split(y, 3, dim=1)
            m = self.mp(a)
            v = self.ap(b)
            z = torch.clamp(torch.cat([m, v], 1), -6.0, -4.5)
            return torch.softmax(z, dim=1), z.mean(dim=(2, 3), keepdim=True), torch.tanh(z).exp().sqrt()

    torch.manual_seed(3)
    m = Net()
    with torch.no_grad():
        m.act.weight.uniform_(0.05, 0.5)
    x = np.random.default_rng(3).standard_normal((2, 4, 9, 11), np.float32)
    roundtrip(m, x, tmp_path)


def test_micro_scrfd_graph(tmp_path):
    torch.manual_seed(3)
    x = np.random.default_rng(3).standard_normal((1, 3, 64, 64), np.float32)
    path = roundtrip(MicroScrfd(), x, tmp_path)
    assert len(t_onnx.import_onnx(path).output_names) == 9  # score/bbox/kps x 3 strides


def test_tile_batch_run_matches_vmap(tmp_path):
    """A graph exported at batch 1 over three tiles: the port's loop over
    tiles against ``jax.vmap`` with an inner batch of 1."""
    from facedet_tpu_torch.engine.onnx_wrapper import run_tile_batch

    torch.manual_seed(4)
    m = MicroScrfd()
    path = str(tmp_path / "s.onnx")
    export_onnx(m, torch.randn(1, 3, 64, 64), path)
    jm, tm = jax_onnx.import_onnx(path), t_onnx.import_onnx(path)
    assert tm.graph.input_shapes[tm.input_names[0]][0] == 1
    tiles = np.random.default_rng(4).standard_normal((3, 3, 64, 64), np.float32)
    want = jax.jit(jax.vmap(lambda t: jm(jm.params, t[None])))(jnp.asarray(tiles))

    class Holder:
        _onnx = tm
        variables = {"params": tm.params_on("cpu")}

    got = run_tile_batch(Holder, torch.from_numpy(tiles))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.shape[:2] == (3, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    # this graph's batch 1 is baked into its Reshape constants: one run on
    # all three tiles cannot stand in for the loop
    whole = tm(tm.params_on("cpu"), torch.from_numpy(tiles))
    assert all(o.shape[0] == 1 for o in whole)


def test_dynamic_batch_graph_runs_batched(tmp_path):
    """Exported with a dynamic batch axis, the Shape -> Gather -> Concat ->
    Reshape chains fold in numpy and one run of the executor takes a batch
    of three."""
    torch.manual_seed(5)
    m = MicroScrfd().eval()
    path = str(tmp_path / "dyn.onnx")
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda proto, custom_opsets: proto
    try:
        torch.onnx.export(m, torch.randn(1, 3, 64, 64), path, opset_version=11, dynamo=False,
                          input_names=["x"], dynamic_axes={"x": {0: "batch"}})
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig
    tm = t_onnx.import_onnx(path)
    assert tm.graph.input_shapes[tm.input_names[0]][0] <= 0 and tm.input_hw() == (64, 64)
    tiles = np.random.default_rng(5).standard_normal((3, 3, 64, 64), np.float32)
    outs = both(path, tiles)
    with torch.no_grad():
        want = m(torch.from_numpy(tiles))
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-4, rtol=1e-4)


def test_parse_reports_shapes_and_graph_equal_field_by_field(tmp_path):
    torch.manual_seed(5)
    path = str(tmp_path / "g.onnx")
    export_onnx(MicroScrfd(), torch.randn(1, 3, 64, 64), path)
    g, want = t_onnx.parse_onnx(path), jax_onnx.parse_onnx(path)
    assert g.input_names == want.input_names and g.output_names == want.output_names
    assert g.input_shapes == want.input_shapes and g.name == want.name
    assert g.input_shapes[g.input_names[0]][1:] == [3, 64, 64]
    assert len(g.nodes) == len(want.nodes)
    for a, b in zip(g.nodes, want.nodes):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert set(da["attrs"]) == set(db["attrs"])
        for k, v in da.pop("attrs").items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(db["attrs"][k]))
        db.pop("attrs")
        assert da == db
    assert set(g.initializers) == set(want.initializers)
    for k, v in g.initializers.items():
        assert v.dtype == want.initializers[k].dtype
        np.testing.assert_array_equal(v, want.initializers[k])
    assert {"Conv", "Relu", "Add", "Sigmoid"} <= {n.op_type for n in g.nodes}
    assert t_onnx.import_onnx(path).input_hw() == (64, 64)
    (tmp_path / "junk.onnx").write_bytes(b"\x08\x01")
    with pytest.raises(ValueError, match="no GraphProto"):
        t_onnx.parse_onnx(str(tmp_path / "junk.onnx"))


def test_grid_sample_topk_layernorm(tmp_path):
    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(6)

        def forward(self, x):
            n, c, h, w = x.shape
            ys = torch.linspace(-0.9, 0.9, 5)
            xs = torch.linspace(-0.9, 0.9, 6)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            grid = torch.stack([gx, gy], -1)[None].expand(n, -1, -1, -1)
            s = torch.nn.functional.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
            s = self.ln(s.flatten(2).transpose(1, 2).reshape(n, 5 * c, 6))
            vals, idx = torch.topk(s, k=3, dim=1)
            return vals, idx

    torch.manual_seed(8)
    m = Net().eval()
    x = np.random.default_rng(8).standard_normal((2, 4, 9, 11), np.float32)
    path = str(tmp_path / "ops16.onnx")
    export_onnx(m, torch.as_tensor(x), path, opset=16)
    with torch.no_grad():
        want = [t.numpy() for t in m(torch.as_tensor(x))]
    vals, idx = both(path, x)
    assert idx.dtype == np.int64
    np.testing.assert_allclose(vals, want[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(idx, want[1])


@pytest.mark.parametrize("mode,padding,align", [
    ("bilinear", "zeros", False),
    ("bilinear", "zeros", True),
    ("bilinear", "border", False),
    ("bilinear", "border", True),
    ("nearest", "zeros", False),
    ("nearest", "zeros", True),
    ("nearest", "border", False),
    ("nearest", "border", True),
])
def test_grid_sample_padding_and_align_variants(tmp_path, mode, padding, align):
    class Net(nn.Module):
        def forward(self, x):
            n = x.shape[0]
            ys = torch.linspace(-1.4, 1.4, 4)  # partly out of bounds
            xs = torch.linspace(-1.4, 1.4, 5)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            grid = torch.stack([gx, gy], -1)[None].expand(n, -1, -1, -1)
            return torch.nn.functional.grid_sample(x, grid, mode=mode, padding_mode=padding, align_corners=align)

    x = np.random.default_rng(9).standard_normal((1, 3, 7, 8), np.float32)
    roundtrip(Net().eval(), x, tmp_path, opset=16)


# --- graphs built by hand: ops and attributes an export does not reach -----

def _graph(nodes, initializers, in_shape, outputs, t=t_onnx):
    nodes = [t.OnnxNode(op, list(i), list(o), dict(a)) for op, i, o, a in nodes]
    return t.OnnxGraph(nodes, dict(initializers), ["x"], list(outputs), {"x": list(in_shape)})


def run_hand_graph(nodes, initializers, x, outputs=("y",)):
    jm = jax_onnx.OnnxModule(_graph(nodes, initializers, x.shape, outputs, jax_onnx))
    tm = t_onnx.OnnxModule(_graph(nodes, initializers, x.shape, outputs, t_onnx))
    want = jm(jm.params, jnp.asarray(x))
    got = tm(tm.params, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    return [g.numpy() for g in got]


HAND_CASES = {
    "average_pool_counts_real_elements": (
        [("AveragePool", ["x"], ["y"], {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]})], {}),
    "max_pool_asymmetric_pads": (
        [("Neg", ["x"], ["n"], {}), ("Relu", ["n"], ["r"], {}), ("Neg", ["r"], ["m"], {}),
         ("MaxPool", ["m"], ["y"], {"kernel_shape": [2, 2], "strides": [2, 2], "pads": [0, 1, 1, 0]})], {}),
    "conv_asymmetric_pads_and_dilation": (
        [("Conv", ["x", "w", "b"], ["y"], {"pads": [2, 0, 1, 3], "dilations": [2, 1]})],
        {"w": np.random.default_rng(41).standard_normal((4, 3, 3, 3)).astype(np.float32),
         "b": np.random.default_rng(42).standard_normal(4).astype(np.float32)}),
    "pad_with_axes_input": (
        [("Pad", ["x", "p", "v", "ax"], ["y"], {})],
        {"p": np.array([1, 2, 0, 3], np.int64), "v": np.array(1.5, np.float32), "ax": np.array([-1, 2], np.int64)}),
    "pad_reflect": ([("Pad", ["x", "p"], ["y"], {"mode": "reflect"})], {"p": np.array([0, 0, 2, 3, 0, 0, 1, 2], np.int64)}),
    "pad_edge": ([("Pad", ["x", "p"], ["y"], {"mode": "edge"})], {"p": np.array([0, 0, 2, 0, 0, 0, 1, 4], np.int64)}),
    "slice_open_end_and_step": (
        [("Slice", ["x", "s", "e", "a", "st"], ["y"], {})],
        {"s": np.array([1, 0], np.int64), "e": np.array([2**31 + 5, 2**63 - 1], np.int64),
         "a": np.array([2, 3], np.int64), "st": np.array([1, 2], np.int64)}),
    "slice_opset9_attributes": ([("Slice", ["x"], ["y"], {"starts": [0, 1], "ends": [2, 3], "axes": [0, 1]})], {}),
    "resize_nearest_non_integer_ratio": (
        [("Resize", ["x", "", "", "sz"], ["y"], {"mode": "nearest"})], {"sz": np.array([2, 3, 7, 11], np.int64)}),
    "resize_linear_shrinks_antialiased": (
        [("Resize", ["x", "", "sc"], ["y"], {"mode": "linear"})], {"sc": np.array([1, 1, 0.5, 0.4], np.float32)}),
    "resize_linear_grows": (
        [("Resize", ["x", "", "sc"], ["y"], {"mode": "linear"})], {"sc": np.array([1, 1, 2.0, 1.5], np.float32)}),
    "resize_cubic_keys_half": (
        [("Resize", ["x", "", "sc"], ["y"], {"mode": "cubic"})], {"sc": np.array([1, 1, 2.0, 2.0], np.float32)}),
    "upsample_attribute_scales": ([("Upsample", ["x"], ["y"], {"scales": [1.0, 1.0, 2.0, 2.0], "mode": "nearest"})], {}),
    "shape_chain_folds_statically": (
        [("Shape", ["x"], ["sh"], {}), ("Gather", ["sh", "i0"], ["b"], {"axis": 0}),
         ("Unsqueeze", ["b"], ["b1"], {"axes": [0]}), ("Concat", ["b1", "m1"], ["tgt"], {"axis": 0}),
         ("Reshape", ["x", "tgt"], ["y"], {})],
        {"i0": np.array(0, np.int64), "m1": np.array([-1], np.int64)}),
    "reshape_zero_copies_a_dimension": (
        [("Reshape", ["x", "tgt"], ["y"], {})], {"tgt": np.array([2, -1, 10], np.int64)}),
    "where_expand_reduce_and_compare": (
        [("Greater", ["x", "z"], ["c"], {}), ("Where", ["c", "x", "half"], ["w"], {}),
         ("ReduceMax", ["w"], ["mx"], {"axes": [1], "keepdims": 1}), ("ReduceMin", ["w"], ["mn"], {"axes": [1], "keepdims": 1}),
         ("Sub", ["mx", "mn"], ["d"], {}), ("Shape", ["x"], ["sh"], {}), ("Expand", ["d", "sh"], ["e"], {}),
         ("ReduceSum", ["e"], ["s"], {"axes": [3], "keepdims": 0}), ("Pow", ["s", "two"], ["p"], {}),
         ("Div", ["one", "e"], ["inv"], {}), ("Min", ["inv", "e"], ["y"], {})],
        {"z": np.array(0.0, np.float32), "half": np.array(0.5, np.float32), "two": np.array(2.0, np.float32),
         "one": np.array(1.0, np.float32)}),
    "gather_squeeze_transpose_matmul_gemm": (
        [("Gather", ["x", "idx"], ["g"], {"axis": 1}), ("Transpose", ["g"], ["t"], {"perm": [0, 2, 3, 1]}),
         ("MatMul", ["t", "m"], ["mm"], {}), ("Flatten", ["mm"], ["f"], {"axis": 1}),
         ("Gemm", ["f", "gw", "gb"], ["y"], {"transB": 1, "alpha": 0.5, "beta": 2.0})],
        {"idx": np.array([2, 0], np.int64), "m": np.random.default_rng(43).standard_normal((2, 3)).astype(np.float32),
         "gw": np.random.default_rng(44).standard_normal((4, 150)).astype(np.float32),
         "gb": np.random.default_rng(45).standard_normal(4).astype(np.float32)}),
    "global_average_pool_erf_floor_log": (
        [("GlobalAveragePool", ["x"], ["g"], {}), ("Erf", ["g"], ["e"], {}), ("Mul", ["x", "e"], ["m"], {}),
         ("Floor", ["m"], ["fl"], {}), ("Mul", ["x", "x"], ["sq"], {}), ("Add", ["sq", "one"], ["p"], {}),
         ("Log", ["p"], ["lg"], {}), ("Add", ["lg", "fl"], ["y"], {})],
        {"one": np.array(1.0, np.float32)}),
}


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_hand_built_graph_matches_the_jax_executor(name):
    nodes, inits = HAND_CASES[name]
    x = np.random.default_rng(46).standard_normal((2, 3, 5, 10)).astype(np.float32)
    run_hand_graph(nodes, inits, x)


def test_conv_auto_pad_same_equals_explicit_pads():
    """``auto_pad`` SAME_UPPER on a 5x10 map, kernel 4, stride 2: total pads
    (3, 2), the odd row at the end, as XLA's "SAME". The JAX executor means
    to take it (its ``padding = "SAME"`` branch) but raises first, in
    ``_pool_padding``; the port is held against the same conv with explicit
    pads."""
    x = np.random.default_rng(46).standard_normal((2, 3, 5, 10)).astype(np.float32)
    w = np.random.default_rng(40).standard_normal((5, 3, 4, 4)).astype(np.float32)
    same = t_onnx.OnnxModule(_graph([("Conv", ["x", "w"], ["y"], {"auto_pad": "SAME_UPPER", "strides": [2, 2]})], {"w": w}, x.shape, ["y"]))
    got = same(same.params, x)[0]
    want = run_hand_graph([("Conv", ["x", "w"], ["y"], {"pads": [1, 1, 2, 1], "strides": [2, 2]})], {"w": w}, x)[0]
    assert got.shape == (2, 5, 3, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with pytest.raises(NotImplementedError, match="auto_pad"):
        jm = jax_onnx.OnnxModule(_graph([("Conv", ["x", "w"], ["y"], {"auto_pad": "SAME_UPPER"})], {"w": w}, x.shape, ["y"], jax_onnx))
        jm(jm.params, jnp.asarray(x))


def test_top_k_ties_break_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]], np.float32)
    nodes = [("TopK", ["x", "k"], ["v", "i"], {"axis": -1})]
    vals, idx = run_hand_graph(nodes, {"k": np.array([3], np.int64)}, x, outputs=("v", "i"))
    np.testing.assert_array_equal(idx, [[1, 2, 4]])
    assert idx.dtype == np.int64
    vals, idx = run_hand_graph([("TopK", ["x", "k"], ["v", "i"], {"axis": -1, "largest": 0})],
                               {"k": np.array([2], np.int64)}, x, outputs=("v", "i"))
    np.testing.assert_array_equal(idx, [[5, 0]])


def test_unsupported_things_raise_as_in_the_jax_executor():
    x = torch.zeros(1, 3, 4, 4)
    for t in (t_onnx, jax_onnx):
        with pytest.raises(NotImplementedError, match="not supported"):
            t.OnnxModule(_graph([("Einsum", ["x"], ["y"], {})], {}, x.shape, ["y"], t))
    for nodes in (
        [("MaxPool", ["x"], ["y"], {"kernel_shape": [2, 2], "auto_pad": "SAME_UPPER"})],
        [("Pad", ["x", "p"], ["y"], {"mode": "wrap"})],
    ):
        inits = {"p": np.zeros(8, np.int64)}
        with pytest.raises(NotImplementedError):
            m = t_onnx.OnnxModule(_graph(nodes, inits, x.shape, ["y"]))
            m(m.params, x)
        with pytest.raises(NotImplementedError):
            m = jax_onnx.OnnxModule(_graph(nodes, inits, x.shape, ["y"], jax_onnx))
            m(m.params, jnp.zeros((1, 3, 4, 4)))
    with pytest.raises(NotImplementedError, match="neither scales nor sizes"):
        m = t_onnx.OnnxModule(_graph([("Resize", ["x", "", ""], ["y"], {})], {}, x.shape, ["y"]))
        m(m.params, x)
    with pytest.raises(KeyError):  # an unknown Resize mode is refused, never replaced
        m = t_onnx.OnnxModule(_graph([("Resize", ["x", "", "sc"], ["y"], {"mode": "area"})],
                                     {"sc": np.array([1, 1, 2, 2], np.float32)}, x.shape, ["y"]))
        m(m.params, x)
