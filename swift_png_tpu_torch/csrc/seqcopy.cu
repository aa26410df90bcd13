// K2: in-order execution of merged LZ77 match records, one block per stream.
//
// Replaces the Pallas kernel swift_png_tpu/ops/inflate_seqcopy.py
// (_seqcopy_kernel, launched by seqcopy_expand) and its feasibility version
// tools/exp_seqcopy.py (_kernel, launched by seqcopy), whose function is a
// subset of K2's.
//
// Each stream's output row starts as its literal-placed bytes.  Its records
// (pos, d, len) run in stream order with forward-copy semantics:
// out[pos + i] = out[pos + i - d] for i in [0, len).  Unrolled, that is the
// closed form out[pos + i] = out[pos - d + (i % d)]: the bytes [pos - d, pos)
// are final before the record starts, so a self-overlapping run (d < len)
// needs no chunk doubling, and every byte of a record is independent of the
// others.  The block's threads stride over the record's bytes, then one
// barrier orders it before the next record.  The TPU kernel's 128-lane rows,
// rotates and tiled/generic split are layout work for the TPU and have no
// counterpart here.
//
// `out` is read and written in the same kernel, so it is never read through
// the read-only path; __syncthreads() makes the block's global writes
// visible to the whole block.  Hostile records stay inside the stream's row:
// a write at or past Opad is dropped, a source before byte 0 reads 0, and a
// record with d < 1 does nothing (the plain version does the same).
//
// What bounds it: one block-wide barrier and one dependent global round trip
// per record, on B of the card's 132 SMs, not the bytes it moves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    seqcopy_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ recs,
                   const uint8_t* __restrict__ lit, uint8_t* out, int Opad,
                   int nrec) {
  const size_t row = static_cast<size_t>(blockIdx.x) * Opad;
  const uint8_t* src = lit + row;
  uint8_t* o = out + row;
  const int t = threadIdx.x;
  if ((Opad & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int i = t; i < (Opad >> 4); i += blockDim.x) o4[i] = s4[i];
  } else {
    for (int i = t; i < Opad; i += blockDim.x) o[i] = src[i];
  }
  __syncthreads();
  const int rs = min(max(starts[blockIdx.x], 0), nrec);
  const int re = min(max(starts[blockIdx.x + 1], rs), nrec);
  for (int r = rs; r < re; ++r) {
    const long long pos = recs[3 * r];
    const int d = recs[3 * r + 1];
    const long long len = recs[3 * r + 2];
    if (d >= 1) {
      // targets q = pos + i in [0, Opad) with 0 <= i < len; the rest are
      // dropped.  Valid records have 0 <= i < Opad, so the modulus is a
      // 32-bit one; only a hostile pos < 0 takes the 64-bit one.
      const long long q0 = max(pos, 0LL);
      const long long q1 = min(pos + len, static_cast<long long>(Opad));
      for (long long q = q0 + t; q < q1; q += blockDim.x) {
        const long long i = q - pos;
        const long long m =
            i < d ? i : (i <= INT32_MAX ? static_cast<int>(i) % d : i % d);
        const long long s = pos - d + m;
        o[q] = s >= 0 ? o[s] : 0;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K2 on `stream`: starts (B + 1,) i32, recs (nrec, 3) i32
// [stream-local pos, d, len], lit (B, Opad) u8 -> out (B, Opad) u8.
extern "C" int spt_seqcopy(const void* starts, const void* recs,
                           const void* lit, void* out, int B, int Opad,
                           int nrec, void* stream) {
  if (B <= 0 || Opad <= 0) return 0;
  if (nrec < 0) return static_cast<int>(cudaErrorInvalidValue);
  seqcopy_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(recs),
      static_cast<const uint8_t*>(lit), static_cast<uint8_t*>(out), Opad,
      nrec);
  return static_cast<int>(cudaGetLastError());
}
