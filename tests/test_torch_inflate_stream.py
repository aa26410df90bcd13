"""The general inflate's CUDA kernel (``csrc/inflate_stream.cu``) from the
CPU: its registration against its C signature, the routing by device, the
status-to-error mapping both paths share, and the kernel's source compiled
for the host with one lane (a thread per block, the warp's loops run by
that lane alone) in place of the launch, held against the plain path:
``InflateFused.run``'s bytes, Adler-32 or error, and its ``last_run``, on
valid streams and seeded corruptions, and ``_inflate``'s every field at
one budget, failed streams' bytes included, on the same streams and on
rows with random bytes past the stream.  The port alone: no
JAX.  On the card, ``tests/test_torch_cuda.py`` holds the kernel itself to
the same."""

import ctypes
import re
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from swift_png_tpu_torch import _kernels
from swift_png_tpu_torch._host.lz77.errors import DecompressionError
from swift_png_tpu_torch.ops import inflate_fused as P

SOURCE = _kernels.CSRC / "inflate_stream.cu"

# the CUDA names the kernel uses, for one lane on the host
SHIM = """
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
#define __constant__ static const
#define __shared__ static
struct Dim3 { unsigned x; };
static Dim3 threadIdx{0}, blockIdx{0};
static inline unsigned __match_any_sync(unsigned, int) { return 1u; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (x >> i & 1u) << (31 - i);
  return r;
}
static inline void __syncwarp() {}
static inline float __frcp_rn(float x) { return 1.0f / x; }
static inline unsigned __float2uint_rz(float x) { return (unsigned)x; }
template <class T> static inline T __ldg(const T* p) { return *p; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
"""

LAUNCH = """
extern "C" int host_inflate_stream(
    const void* data, long long stride, long long n, int B, void* out,
    long long out_stride, long long out_size, long long w0, long long t0,
    long long wl, long long tl, long long tok_cap, long long max_blocks,
    void* info) {
  const Budget bg{w0, t0, wl, tl, tok_cap, max_blocks};
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    inflate_stream_kernel(static_cast<const uint8_t*>(data), stride, n,
                          static_cast<uint8_t*>(out), out_stride, out_size,
                          bg, static_cast<int64_t*>(info));
  }
  return 0;
}
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``inflate_stream_cuda`` with the kernel's source built by ``g++``
    for one lane and run on CPU tensors."""
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>\n", "")
    src = src.replace("constexpr int kLanes = 32;",
                      "constexpr int kLanes = 1;")
    src = src.replace("extern __shared__ uint4 ring_mem[];",
                      "static uint4 ring_mem[kRing / 16];")
    src = src[:src.index('extern "C" const char* spt_error_string')]
    d = tmp_path_factory.mktemp("inflate_stream")
    (d / "model.cpp").write_text(SHIM + src + LAUNCH)
    subprocess.run([shutil.which("g++") or "g++", "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-o", str(d / "model.so"),
                    str(d / "model.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "model.so"))
    L = ctypes.c_longlong
    lib.host_inflate_stream.argtypes = ([ctypes.c_void_p, L, L, ctypes.c_int,
                                         ctypes.c_void_p] + [L] * 8
                                        + [ctypes.c_void_p])

    def launch(D, n, out_size, first, last, max_blocks, tok_cap):
        B, stride = D.shape
        out = torch.zeros((B, out_size + (-out_size) % 32768),
                          dtype=torch.uint8)
        info = torch.zeros((B, 8), dtype=torch.int64)
        D = D.contiguous()
        lib.host_inflate_stream(D.data_ptr(), stride, n, B, out.data_ptr(),
                                out.shape[1], out_size, *first, *last,
                                tok_cap, max_blocks, info.data_ptr())
        return out, info
    return launch


def _outcome(eng, size, fn):
    """The bytes and Adler-32 ``fn`` returns, or its error's class and
    case; with the engine's ``last_run``."""
    try:
        out, adler = fn()
        got = bytes(out[:size].numpy()), adler
    except DecompressionError as e:
        got = type(e).__name__, e.case
    return got, dict(eng.last_run)


def test_cpu_device_runs_the_plain_path():
    data = bytes(range(256)) * 30
    eng = P.InflateFused(win_bytes=1 << 12, t_max=1 << 10, device="cpu")
    _kernels.reset_launches()
    out, adler = eng.run(zlib.compress(data, 6)[2:-4], len(data))
    assert _kernels.launch_counts()["inflate_stream"] == 0
    assert out.device.type == "cpu"
    assert bytes(out[:len(data)].numpy()) == data
    assert adler == zlib.adler32(data)


def test_status_maps_to_the_errors_run_raised():
    """Every flag combination raises the case ``run``'s own chain raised
    before both paths shared it: the first flag that applies in this
    order, else an invalid Huffman table."""
    order = [(P.F_BAD_BLOCK, "invalidBlockTypeCode"),
             (P.F_BAD_PARITY, "invalidBlockElementCountParity"),
             (P.F_BAD_DISTANCE, "invalidStringReference"),
             (P.F_BAD_CODE, "invalidHuffmanTable"),
             (P.F_OUTPUT_MISMATCH, "invalidStreamChecksum"),
             (P.F_TOO_MANY_BLOCKS | P.F_OVERFLOW, "invalidBlockTypeCode")]
    for status in range(1, 128):
        want = next((case for bits, case in order if status & bits),
                    "invalidHuffmanTable")
        with pytest.raises(DecompressionError) as err:
            P._raise_status(status)
        assert err.value.case == want, status


def test_kernel_registered_with_its_c_signature():
    """``_kernels.KERNELS["inflate_stream"]`` names the source, the symbol
    and, in order, the ctypes type of every parameter of the launch
    function."""
    k = _kernels.KERNELS["inflate_stream"]
    assert (k.source, k.symbol) == ("inflate_stream.cu",
                                    "spt_inflate_stream")
    src = SOURCE.read_text()
    params = re.search(r'extern "C" int spt_inflate_stream\(([^)]*)\)',
                       src).group(1)
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int}
    want = [kinds[re.sub(r"\s+\w+$", "", p.strip())]
            for p in params.split(",")]
    assert k.argtypes == want


CASES = chip_smoke.inflate_stream_cases(corrupt=24)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_source_on_host_matches_run(name, host_kernel, monkeypatch):
    """``InflateFused.run`` through the kernel's route (one launch for the
    whole retry loop, the retries counted from the needs it reports) and
    through the plain loop, at the default budgets and at budgets small
    enough that valid streams retry."""
    monkeypatch.setattr(P, "inflate_stream_cuda", host_kernel)
    body, size = CASES[name]
    for budget in ({}, {"win_bytes": 64, "t_max": 8}):
        plain = P.InflateFused(device="cpu", **budget)
        kern = P.InflateFused(device="cpu", **budget)
        monkeypatch.setattr(kern, "_decode", kern._decode_kernel)
        got = _outcome(kern, size, lambda: kern.run(body, size))
        assert got == _outcome(plain, size, lambda: plain.run(body, size))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_source_on_host_matches_plain_fields(seed, host_kernel,
                                                    monkeypatch):
    """The kernel's route at one budget (``_inflate_cuda``, as
    ``inflate_fused_batch`` takes it on the card) against ``_inflate``:
    every field of every stream, failed ones included (status, end bit,
    block count, bytes and Adler-32), on rows whose bytes past the stream
    are random (windows and reads clamped into the row as
    ``lax.dynamic_slice`` and JAX's gathers clamp them)."""
    rng = np.random.default_rng(seed)
    win, t_max, out_size = 1 << 12, 1 << 10, 2000
    data = bytes(rng.integers(0, 6, out_size, dtype=np.uint8))
    body = zlib.compress(data, 9)[2:-4]
    n = len(body) + win + 8
    Ds = rng.integers(0, 256, (24, n), dtype=np.uint8)
    for i in range(24):
        Ds[i, :len(body)] = np.frombuffer(body, np.uint8)
        if i % 2:
            for _ in range(i // 4 + 1):
                bit = int(rng.integers(0, 8 * len(body)))
                Ds[i, bit >> 3] ^= 1 << (bit & 7)
        if i % 3 == 0:
            Ds[i, len(body):] = 0
    want = P._inflate(Ds, torch.from_numpy(Ds), out_size, win, t_max,
                      1 << 14, out_size + 1)
    monkeypatch.setattr(P, "inflate_stream_cuda", host_kernel)
    got = P._inflate_cuda(torch.from_numpy(Ds), n, out_size, (win, t_max),
                          (win, t_max), 1 << 14, out_size + 1)
    ok = want[1] == 0
    assert ok[0] and not ok.all()
    assert torch.equal(got[0], want[0])
    for k in (1, 2, 3, 4):       # status, end bit, Adler-32, blocks
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("budget", [(1 << 17, 1 << 15), (1 << 12, 1 << 9)],
                         ids=["default", "small"])
def test_kernel_source_on_host_matches_plain_on_cases(budget, host_kernel,
                                                      monkeypatch):
    """Every field of ``_inflate_cuda`` against ``_inflate`` at one budget
    over :func:`chip_smoke.inflate_stream_cases` (each stream alone, in
    its zero-padded row): at the default budgets, and at budgets that cut
    the long streams' blocks, so that a block whose bytes were written is
    dropped."""
    win, t_max = budget
    monkeypatch.setattr(P, "inflate_stream_cuda", host_kernel)
    for name, (body, size) in CASES.items():
        Ds = P._stack([body], len(body) + win + 8)
        want = P._inflate(Ds, torch.from_numpy(Ds), size, win, t_max,
                          1 << 14, size + 1)
        got = P._inflate_cuda(torch.from_numpy(Ds), Ds.shape[1], size,
                              budget, budget, 1 << 14, size + 1)
        assert torch.equal(got[0], want[0]), name
        for k in (1, 2, 3, 4):
            assert np.array_equal(got[k], want[k]), (name, k)
