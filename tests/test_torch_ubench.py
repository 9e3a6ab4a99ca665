"""The microbenchmarks U1 (leaf-test stages) and U2 (K1's call shape): the
port's plain versions and (on a card) its CUDA kernels, against the
reference's own tools, unedited.

`tools/ubench_leaf.py` and `tools/ubench_grid.py` run here as scripts
(`runpy`, their `main()` with `sys.argv` set) with `jax.jit` replaced by
the identity, so the calls run eagerly, and every `pallas_call` forced to
`interpret=True` and recorded (inputs and outputs). U2's `bench` import
is a stand-in whose `build_scene` returns the seeded test scene of
`_torch_scene.py` packed by `rfw_tpu` (`RFW_NO_NATIVE=1`): the reference
tool loads pica, which is not in the repository.

Tolerances:
  * U2, every variant, all five outputs: exact;
  * U1 `madds`: exact; `fetch`: exact where the reference rounds
    (|ox|*100) and +1 separately, and otherwise equal to the once-rounded
    |ox|*100 + 1 (XLA's CPU compiler fuses the two into one multiply-add
    in some lanes; the port rounds twice, as the kernel does);
  * U1 `full`, `noselect`, `epilogue`: t within 3e-5 relative, except at
    most 4 of the 1,024 lanes (counted). The reference takes t from an
    approximate reciprocal refined by one Newton step where the port
    divides exactly, and XLA fuses products and sums into multiply-adds,
    so t differs by a few ulps, and by more where the dot products cancel
    or a slot passes a bound test in one and not the other;
  * U1 `fused` and `staged` (the port's own variants, the reference's
    arithmetic on the card's multiply-adds) against the reference's
    `full`: the same, and against a float64 evaluation of the step they
    are no further off than `full` is;
  * the CUDA kernels against the plain versions (on a card): identical,
    but for `fused` and `staged` (t within 3e-5 relative on all but at
    most 4 lanes: the plain version cannot round the card's MUFU.RCP
    alike).
"""

import json
import runpy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.ops.traverse import prepare_scene
from rfw_tpu_torch.tools import ubench_grid as ug
from rfw_tpu_torch.tools import ubench_leaf as ul

TOOLS = Path(__file__).resolve().parent.parent / "tools"
LEAF_ITERS = (2, 4)  # the reference tool's --iters 2: it runs 2 and 4
FLIP_LANES = 4
REF_VARIANTS = ("full", "noselect", "madds", "epilogue", "fetch")  # the reference's, in order
FUSED_VARIANTS = ("fused", "staged")  # the port's, held by tolerance


def _run_tool(script: str, argv, bench=None):
    """Run tools/<script> as a script, eagerly, with every pallas_call in
    interpret mode; returns [(inputs, outputs)] of its calls as numpy."""
    calls = []
    orig = pallas.pallas_call

    def pallas_call(kernel, *a, **kw):
        kw["interpret"] = True
        f = orig(kernel, *a, **kw)

        def call(*args):
            out = f(*args)
            calls.append(([np.asarray(x) for x in args],
                          jax.tree_util.tree_map(np.asarray, out)))
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", pallas_call)
        mp.setattr(jax, "jit", lambda f=None, **kw: f if f is not None else (lambda g: g))
        mp.setattr(sys, "argv", [str(TOOLS / script), *argv])
        mp.setattr(sys, "path", list(sys.path))
        if bench is not None:
            mp.setitem(sys.modules, "bench", bench)
        runpy.run_path(str(TOOLS / script), run_name="__main__")
    return calls


# ------------------------------------------------------------------- U1
@pytest.fixture(scope="module")
def leaf_ref():
    calls = _run_tool("ubench_leaf.py", ["--interpret", "--iters", "2", "--reps", "1"])
    assert len(calls) == len(REF_VARIANTS) * len(LEAF_ITERS) * 2  # warm-up + 1 rep
    tri, obj = ul.make_inputs()
    out = {}
    for i, (args, t) in enumerate(calls):
        v, k = divmod(i // 2, len(LEAF_ITERS))
        out.setdefault((REF_VARIANTS[v], LEAF_ITERS[k]), []).append((args, t))
    return dict(tri=tri, obj=obj, out=out)


def _inputs(tri, obj, dev="cpu"):
    return ul.to_records(torch.from_numpy(tri)).to(dev), torch.from_numpy(obj).to(dev)


def test_leaf_inputs_and_layout(leaf_ref):
    """The port draws the reference's inputs, and its record layout holds
    record tri[i, gb*128 + g*16 : +16] in slot i of treelet gb*8 + g."""
    (args, _), = leaf_ref["out"][("full", 2)][:1]
    np.testing.assert_array_equal(leaf_ref["tri"], args[0])
    np.testing.assert_array_equal(leaf_ref["obj"], args[1])
    tri = leaf_ref["tri"]
    recs = ul.to_records(torch.from_numpy(tri)).numpy()
    assert recs.shape == (64 * 8 * 64, 16)
    rng = np.random.default_rng(3)
    for gb, g, i in zip(rng.integers(0, 64, 20), rng.integers(0, 8, 20), rng.integers(0, 64, 20)):
        np.testing.assert_array_equal(recs[(gb * 8 + g) * 64 + i],
                                      tri[i, gb * 128 + g * 16: gb * 128 + g * 16 + 16])


def _chain(tri, iters):
    """The fetch chain in Python integers with int32 wrap-around."""
    idx = 1
    for _ in range(iters):
        v = tri[0, (idx % 64) * 128]
        h = (idx * 1103515245 + 12345 + int(v * np.float32(0.0))) & 0xFFFFFFFF
        idx = (h - 2**32 if h >= 2**31 else h) % 65521
    return idx


@pytest.mark.parametrize("iters", LEAF_ITERS)
@pytest.mark.parametrize("variant", REF_VARIANTS)
def test_leaf_plain_matches_reference(leaf_ref, variant, iters):
    recs, obj = _inputs(leaf_ref["tri"], leaf_ref["obj"])
    got = ul.leaf_plain(recs, obj, variant, iters)
    assert got.t.shape == (1, 8, 128) and got.aux.dtype == torch.int32
    refs = [t for _, t in leaf_ref["out"][(variant, iters)]]
    np.testing.assert_array_equal(refs[0], refs[1])
    ref, t = refs[0], got.t.numpy()
    t0 = np.abs(leaf_ref["obj"][0]) * np.float32(100.0)
    group = int(t0[0, 0]) % 8
    if variant == "fetch":
        ox = np.abs(leaf_ref["obj"][0]).astype(np.float64)
        fused = (ox * 100.0 + 1.0).astype(np.float32)  # exact in float64, rounded once
        np.testing.assert_array_equal(t[0], t0 + np.float32(1.0))
        assert np.all((ref[0] == t[0]) | (ref[0] == fused))
        assert np.all(got.aux.numpy() == _chain(leaf_ref["tri"], iters))
        return
    assert np.all(got.aux.numpy() == group)
    if variant == "madds":
        np.testing.assert_array_equal(t, ref)
        return
    rel = np.abs(t - ref) / np.abs(ref)
    outliers = int((rel > 3e-5).sum())
    assert outliers <= FLIP_LANES, (outliers, rel.max())
    # the steps changed t where the slot tests hit
    assert np.any(t != t0[None])


def _outliers(t, ref):
    """Lanes of t beyond 3e-5 relative of ref, and the largest relative error."""
    rel = np.abs(np.asarray(t, np.float64) - ref) / np.abs(ref)
    return int((rel > 3e-5).sum()), float(rel.max())


@pytest.mark.parametrize("iters", LEAF_ITERS)
@pytest.mark.parametrize("variant", FUSED_VARIANTS)
def test_leaf_fused_plain_matches_reference(leaf_ref, variant, iters):
    """`fused` and `staged` compute the reference's step with the card's
    multiply-adds: within the tolerance of the reference's `full`, and no
    further from a float64 evaluation of the step than the port's `full`
    (exact division, each product and sum rounded alone) is."""
    recs, obj = _inputs(leaf_ref["tri"], leaf_ref["obj"])
    fused = ul.leaf_plain(recs, obj, variant, iters)
    full = ul.leaf_plain(recs, obj, "full", iters)
    ref = leaf_ref["out"][("full", iters)][0][1]
    n, worst = _outliers(fused.t.numpy(), ref)
    assert n <= FLIP_LANES, (n, worst)
    assert torch.equal(fused.aux, full.aux)
    t0 = np.abs(leaf_ref["obj"][0]) * np.float32(100.0)
    assert np.any(fused.t.numpy() != t0[None])  # the steps hit
    exact = ul.leaf_plain(recs.double(), obj.double(), "full", iters).t.numpy()
    assert _outliers(fused.t.numpy(), exact)[0] <= _outliers(full.t.numpy(), exact)[0]


def test_fused_degenerate_slots_never_pass():
    """A slot whose d'_w is 0 or NaN, or whose record holds a NaN, fails
    every compare in the fused contract, as in the exact one."""
    a = torch.zeros((3, 16))
    a[:, 0] = a[:, 5] = 0.25  # u = x/4, v = y/4 at the plane w = z
    a[:, 10] = 1.0
    a[1, 10] = float("nan")
    a[2, 3] = float("nan")
    ray = tuple(torch.tensor([v, v]) for v in (0.5, 0.5, -1.0, 0.0, 0.0, 1.0))
    ok, t, u = ul._fused_slots(a, ray, torch.tensor([10.0, 10.0]))
    assert ok.tolist() == [[True, False, False]] * 2 and t[0, 0] == 1.0
    flat = tuple(torch.tensor([v, v]) for v in (0.5, 0.5, -1.0, 1.0, 0.0, 0.0))
    ok, t, _ = ul._fused_slots(a, flat, torch.tensor([10.0, 10.0]))  # d'_w = 0
    assert not ok.any() and torch.isnan(t).all()


def test_leaf_copies_on_cpu(leaf_ref):
    recs, obj = _inputs(leaf_ref["tri"], leaf_ref["obj"])
    for variant in ("full", *FUSED_VARIANTS):
        one = ul.leaf_plain(recs, obj, variant, 3)
        many = ul.leaf(recs, obj, variant, 3, copies=3)
        assert many.t.shape == (3, 8, 128)
        for k in range(3):
            assert torch.equal(many.t[k], one.t[0]) and torch.equal(many.aux[k], one.aux[0])


@pytest.mark.parametrize("variant", REF_VARIANTS)
def test_leaf_kernel_matches_plain_on_card(leaf_ref, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 9 makes this check on the "
                    "card")
    recs, obj = _inputs(leaf_ref["tri"], leaf_ref["obj"], "cuda")
    ref = ul.leaf_plain(recs, obj, variant, 8)
    got = ul.leaf(recs, obj, variant, 8, copies=4)
    for x, y in zip(got, ref):
        assert torch.equal(x, y.expand_as(x))


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
def test_leaf_fused_kernel_matches_plain_on_card(leaf_ref, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 9 makes this check on the "
                    "card")
    recs, obj = _inputs(leaf_ref["tri"], leaf_ref["obj"], "cuda")
    ref = ul.leaf_plain(recs, obj, variant, 8)
    got = ul.leaf(recs, obj, variant, 8, copies=4)
    assert torch.equal(got.t, got.t[:1].expand_as(got.t))
    assert torch.equal(got.aux, ref.aux.expand_as(got.aux))
    n, worst = _outliers(got.t[0].cpu().numpy(), ref.t[0].cpu().numpy())
    assert n <= FLIP_LANES, (n, worst)


# ------------------------------------------------------------------- U2
@pytest.fixture(scope="module")
def grid_ref():
    from rfw_tpu.render.pack import TraceScene

    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        scene, mats, lights, atlas, _ = _torch_scene.build("rfw_tpu", seed=2)
    finally:
        mp.undo()
    bench = types.ModuleType("bench")
    bench.build_scene = lambda w, h: (TraceScene(*[jnp.asarray(x) for x in scene]),)
    calls = _run_tool("ubench_grid.py", ["--tiles", "2", "--reps", "1"], bench=bench)
    assert len(calls) == len(ug.VARIANTS) * 2  # warm-up + 1 rep
    tscene, *_ = from_numpy_scene(scene, mats, lights, atlas, "cpu")
    return dict(calls=calls, ps=prepare_scene(tscene))


def test_grid_inputs_match_reference(grid_ref):
    """The port draws the reference's rays, in its ray order, and its
    prepared scene reports the reference's tlas_root and n_inst."""
    args, _ = grid_ref["calls"][0]
    meta, o4, d4, tl3 = args[0], args[5], args[6], args[7]
    o, d = ug.make_rays(2)
    np.testing.assert_array_equal(o, o4.transpose(0, 2, 3, 1).reshape(-1, 3))
    np.testing.assert_array_equal(d, d4.transpose(0, 2, 3, 1).reshape(-1, 3))
    assert np.all(tl3 == np.float32(1e26))
    ps = grid_ref["ps"]
    assert (int(meta[0, 0]), int(meta[0, 2])) == (ps.tlas_root, ps.n_inst)


@pytest.mark.parametrize("variant", ug.VARIANTS)
def test_grid_plain_matches_reference(grid_ref, variant):
    o, d = (torch.from_numpy(a) for a in ug.make_rays(2))
    got = ug.grid_plain(grid_ref["ps"], o, d, torch.full((o.shape[0],), 1e26), variant)
    for _, out in grid_ref["calls"][2 * ug.VARIANTS.index(variant):][:2]:
        for x, y in zip(got, out):
            ref = torch.from_numpy(np.array(y).reshape(-1))
            assert x.dtype == ref.dtype and torch.equal(x, ref)
    if variant == "whiletriv":
        assert not torch.equal(got.t, torch.full_like(got.t, 1e26))


@pytest.mark.parametrize("variant", ug.VARIANTS[1:])
def test_grid_keep_alive_rule(grid_ref, variant):
    """The rule that keeps the prologue live: a ray whose re-based floats
    sum to NaN gets prim -2; finite rays never do."""
    o = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 2.0, 3.0]])
    d = torch.tensor([[float("inf"), 0.0, 1.0], [float("nan"), 1.0, 0.0], [0.0, 1.0, 0.0]])
    got = ug.grid_plain(grid_ref["ps"], o, d, 5.0, variant)
    assert got.prim.tolist() == [-2, -2, -1]
    assert torch.equal(ug.grid_plain(grid_ref["ps"], o, d, 5.0, "trivial").prim,
                       torch.full((3,), -1, dtype=torch.int32))


@pytest.mark.parametrize("variant", ug.VARIANTS)
def test_grid_kernel_matches_plain_on_card(grid_ref, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 9 makes this check on the "
                    "card")
    ps = prepare_scene(from_numpy_scene(*_torch_scene.build("rfw_tpu_torch", seed=2)[:4],
                                        "cuda")[0])
    o, d = (torch.from_numpy(a).cuda() for a in ug.make_rays(3))
    tl = torch.full((o.shape[0],), 1e26, device="cuda")
    for x, y in zip(ug.grid(ps, o, d, tl, variant), ug.grid_plain(ps, o, d, tl, variant)):
        assert torch.equal(x, y)


# ------------------------------------------------------- the entry points
@pytest.mark.parametrize("tool,argv", [
    (ul, ["--iters", "2", "--reps", "1", "--copies", "2"]),
    (ug, ["--tiles", "1", "--reps", "1"]),
], ids=["ubench_leaf", "ubench_grid"])
def test_entry_point_needs_a_card_or_cpu(tool, argv, capsys):
    """Without a card the tools raise unless told --device cpu; with it
    they run the plain versions and print one JSON line on stdout."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(argv)
    result = tool.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["device"] == "cpu" and result["clock"] == "host"
    if tool is ul:
        assert set(result["us_per_iter"]) == set(ul.VARIANTS)
    else:
        assert set(result["results"]["1"]) == {*ug.VARIANTS, "k1"}
        assert result["n_inst"] == 512
