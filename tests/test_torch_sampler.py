"""Sobol sampler, Morton codes, pixel swizzle and prefix ladder: the port
against rfw_tpu. Tolerance: none — the integer hashing is bit-exact and so
are the float32 uniforms made from it. The Sobol kernel (csrc/sampler.cu)
against the plain version, bit for bit, on a card; its wrapper's
dispatch, argument bits and counts on the CPU."""

import collections
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rfw_tpu.accel import lbvh as jlbvh
from rfw_tpu.render import sampler as jsampler
from rfw_tpu.render import wavefront as jwave
from rfw_tpu_torch.accel.lbvh import morton_codes_c
from rfw_tpu_torch.render import sampler
from rfw_tpu_torch.render import wavefront
from rfw_tpu_torch.utils import trace

INDICES = [0, 1, 7, 1023, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("sample_index", INDICES)
def test_sample_slot_bit_exact(n, sample_index):
    rng = np.random.default_rng(sample_index % 1000 + n)
    pid = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    for slot in (0, 1, 2, 5, 3 + 7 * 3):
        ref = np.asarray(jsampler.sample_slot(jnp.uint32(sample_index), jnp.asarray(pid),
                                              slot, n))
        got = sampler.sample_slot(sample_index, torch.from_numpy(pid), slot, n).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.array_equal(got, ref), (slot, np.abs(got - ref).max())


def test_sample_slot_per_lane_index():
    """A per-lane sample index (R,) hashes like the broadcast scalar."""
    rng = np.random.default_rng(2)
    pid = rng.integers(0, 1 << 20, 1000).astype(np.int32)
    idx = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jsampler.sample_slot(jnp.asarray(idx), jnp.asarray(pid), 4, 3))
    got = sampler.sample_slot(torch.from_numpy(idx.astype(np.int64)),
                              torch.from_numpy(pid), 4, 3).numpy()
    assert np.array_equal(got, ref)


# sample indices of the kernel checks: 2**32 + 5 wraps to 5, as _u32 masks it
KERNEL_INDICES = [0, 1, 7, 2**31 + 5, 2**32 - 1, 2**32 + 5]


def _pid_orders(R: int, W: int):
    """Pixel ids in the orders the main path draws them: identity, a
    permutation (vertex 0's sort), a prefix of it (a bounce's live lanes)
    and a strip's full-frame ids (row0 = 3 rows of width W)."""
    g = torch.Generator().manual_seed(5)
    ident = torch.arange(R, dtype=torch.int32)
    perm = ident[torch.randperm(R, generator=g)]
    return {"identity": ident, "permutation": perm, "prefix": perm[: R * 5 // 8],
            "strip": ident + 3 * W}


def test_sobol_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode; chip_smoke.py "
                    "phase 19 makes this check on the card")
    for order, pid in _pid_orders(64 * 48, 64).items():
        pid = pid.cuda()
        for n in (2, 3):
            for slot in range(10):
                for si in KERNEL_INDICES:
                    before = sampler.LAUNCHES
                    got = sampler.sample_slot(si, pid, slot, n)
                    assert sampler.LAUNCHES == before + 1
                    ref = sampler.sample_slot_plain(si, pid, slot, n)
                    assert got.shape == ref.shape and got.dtype == torch.float32
                    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (
                        order, n, slot, si)
    pid = _pid_orders(4096, 64)["permutation"].cuda()
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2**33, pid.shape[0], dtype=np.int64)).cuda()
    for n in (2, 3):
        got = sampler.sample_slot(idx, pid, 4, n)
        ref = sampler.sample_slot_plain(idx, pid, 4, n)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("order", ["identity", "permutation", "prefix", "strip"])
def test_cpu_pixel_ids_take_the_plain_path(n, order):
    """Pixel ids on the CPU: the plain version's bits, no kernel launch."""
    pid = _pid_orders(32 * 24, 32)[order]
    before = sampler.LAUNCHES
    for slot in (0, 5, 9):
        got = sampler.sample_slot(2**32 + 5, pid, slot, n)
        ref = sampler.sample_slot_plain(5, pid, slot, n)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert sampler.LAUNCHES == before


@pytest.mark.parametrize("sample_index", [
    0, 1, 7, -1, -(2**31), 2**31 + 5, 2**32 - 1, 2**32 + 5, 2**40 + 3, 2**62 + 11,
    np.uint32(2**32 - 2), np.int64(-3), np.int32(-7), torch.tensor(9),
    torch.tensor(2**32 + 6), torch.tensor(-4, dtype=torch.int32)])
def test_scalar_index_bits_are_u32s(sample_index):
    index, lanes = sampler.index_bits(sample_index, torch.device("cpu"))
    assert lanes is None
    assert index == int(sampler._u32(sample_index))


def test_lane_index_bits_are_u32s():
    idx = torch.tensor([0, 1, -1, 2**31, 2**32 - 1, 2**32 + 5, -(2**40)], dtype=torch.int64)
    index, lanes = sampler.index_bits(idx, torch.device("cpu"))
    assert index == 0 and lanes.dtype == torch.int32
    assert torch.equal(lanes.to(torch.int64) & sampler.M32, sampler._u32(idx))


class _FakeLibrary:
    """The kernel library's entry point, recording each call's arguments."""

    def __init__(self):
        self.calls = []

    def rfw_sobol_slot(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_kernel(monkeypatch):
    """`sampler._launch` on CPU tensors: the library, stream and device
    guard stood in for, so the wrapper's checks, arguments and counts run."""
    from rfw_tpu_torch.ops import _build, traverse

    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda name: lib)
    monkeypatch.setattr(traverse, "stream_of", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    monkeypatch.setattr(trace, "_open", {})
    return lib


@pytest.mark.parametrize("n", [2, 3])
def test_launch_arguments(fake_kernel, n):
    pid = _pid_orders(100, 10)["permutation"]
    before = sampler.LAUNCHES
    out = sampler._launch(2**32 + 5, pid, 2**32 + 3, n)
    assert out.shape == (100, n) and out.dtype == torch.float32
    (args,) = fake_kernel.calls
    assert args[0] == n and args[1].value == pid.data_ptr() and args[2] is None
    assert args[3:6] == (5, 3, 100) and args[6].value == out.data_ptr()
    assert sampler.LAUNCHES == before + 1
    idx = torch.arange(100, dtype=torch.int64) + 2**32
    sampler._launch(idx, pid, 1, n)
    assert fake_kernel.calls[1][2] is not None and fake_kernel.calls[1][3] == 0
    sampler._launch(7, pid[:0], 1, n)  # no lanes: no launch
    assert len(fake_kernel.calls) == 2 and sampler.LAUNCHES == before + 2


@pytest.mark.parametrize("bad", ["int64", "2d", "n4"])
def test_launch_rejects_what_the_kernel_does_not_take(fake_kernel, bad):
    pid = torch.arange(16, dtype=torch.int32)
    args = {"int64": (pid.long(), 2), "2d": (pid.reshape(4, 4), 2), "n4": (pid, 4)}[bad]
    with pytest.raises(ValueError):
        sampler._launch(1, args[0], 0, args[1])
    assert fake_kernel.calls == []


def test_other_devices_raise():
    with pytest.raises(ValueError):
        sampler.sample_slot(1, torch.zeros(4, dtype=torch.int32, device="meta"), 0, 2)


def test_kernel_draws_count_only_while_profiling(fake_kernel):
    pid = torch.arange(64, dtype=torch.int32)
    sampler._launch(1, pid, 0, 2)
    trace.end_frame()
    assert trace.frames() == []
    with profile(activities=[ProfilerActivity.CPU]):
        for slot in range(5):
            sampler._launch(1, pid, slot, 3)
        sampler.sample_slot(1, pid, 0, 2)  # the CPU path counts nothing
        trace.end_frame()
    (rec,) = trace.frames()
    assert rec["counts"] == {"sampler.kernel_draws": 5}


def test_sobol2d_bit_exact():
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    seed = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    r0, r1 = jsampler.sobol2d(jnp.asarray(idx), jnp.asarray(seed))
    g0, g1 = sampler.sobol2d(torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(seed.astype(np.int64)))
    assert np.array_equal(g0.numpy(), np.asarray(r0))
    assert np.array_equal(g1.numpy(), np.asarray(r1))


def test_morton_codes_bit_exact():
    rng = np.random.default_rng(4)
    c = rng.uniform(-12, 12, (3, 4000)).astype(np.float32)
    mn = np.array([-10, -11, -9], np.float32)
    mx = np.array([10, 9, 11], np.float32)
    ref = np.asarray(jlbvh.morton_codes_c(tuple(jnp.asarray(x) for x in c),
                                          jnp.asarray(mn), jnp.asarray(mx)))
    got = morton_codes_c(tuple(torch.from_numpy(x) for x in c),
                         torch.from_numpy(mn), torch.from_numpy(mx)).numpy()
    assert np.array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("wh,lanes", [((32, 32), 256), ((64, 48), 1024),
                                      ((48, 40), 256), ((1920, 1080), 256)])
def test_block_swizzle(wh, lanes):
    ref = jwave._block_swizzle(*wh, lanes)
    got = wavefront._block_swizzle(*wh, lanes)
    if ref is None:
        assert got is None
        return
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("R,g,mb", [(1024, 256, 1), (36864, 256, 1), (2073600, 256, 1),
                                    (2073600, 256, 3), (65536, 1024, 4)])
def test_prefix_sizes(R, g, mb):
    assert wavefront._prefix_sizes(R, g, mb) == jwave._prefix_sizes(R, g, mb)
