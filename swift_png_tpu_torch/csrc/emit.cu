// K6: term emission, packed DeflatorTerm -> (lo, hi, nbits).
//
// Replaces the Pallas kernel swift_png_tpu/ops/deflate_emit.py _emit_kernel
// (launched by emit_terms_batch), which looks each term's codes up with a
// one-hot over the table's sublanes.
//
// A term is a literal (0xF8000000 | byte) or a match (dd << 27 | dist_extra
// << 14 | run_extra << 9 | 0x100 | rd).  Its piece is the literal/run code,
// the run's extra bits, the distance code and the distance's extra bits,
// each OR'd into a 64-bit (lo, hi) window at the running bit offset, read
// from the image's 320-entry table (bits | len << 16; distance decades at
// 288..317) and the RFC 1951 closed forms for the extra-bit widths.  Every
// slot is emitted, dead ones (term 0) included, with the TPU kernel's
// arithmetic, so the outputs match it on the whole grid.
//
// One thread per term, 256 terms per block, all of one image (per_image is
// a multiple of 256); the image's table sits in shared memory.
//
// What bounds it: its bytes (4 in, 12 out per term); the work is some
// thirty integer operations per term.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 320;
constexpr int kThreads = 256;

// OR a <=16-bit piece into the 64-bit (lo, hi) window at bit `off`.
__device__ __forceinline__ void place(unsigned& lo, unsigned& hi,
                                      unsigned piece, int width, int& off) {
  const int sh = off & 31;
  const unsigned shifted = piece << sh;
  const unsigned spill = sh == 0 ? 0u : (piece >> 1) >> (31 - sh);
  if (off >= 32) {
    hi |= shifted;
  } else {
    lo |= shifted;
    hi |= spill;
  }
  off += width;
}

__global__ void __launch_bounds__(kThreads)
    emit_kernel(const int* __restrict__ terms, const int* __restrict__ tabs,
                int* __restrict__ lo_out, int* __restrict__ hi_out,
                int* __restrict__ nb_out, long long n, int per_image) {
  __shared__ int tab[kRows];
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int img = static_cast<int>(t0 / per_image);
  for (int k = threadIdx.x; k < kRows; k += kThreads)
    tab[k] = tabs[img * kRows + k];
  __syncthreads();
  const long long t = t0 + threadIdx.x;
  if (t >= n) return;
  const unsigned tu = static_cast<unsigned>(terms[t]);
  const bool is_lit = (tu >> 27) == 31 && (tu & 0x100u) == 0;
  const int low = static_cast<int>(tu & 0xFFu);
  const int rd = min(low, 28);
  const int dd = min(static_cast<int>(tu >> 27), 29);
  const unsigned run_extra = (tu >> 9) & 0x1Fu;
  const unsigned dist_extra = (tu >> 14) & 0x1FFFu;

  unsigned lo = 0, hi = 0;
  int off = 0;
  const int lv = tab[is_lit ? low : 257 + rd];
  place(lo, hi, static_cast<unsigned>(lv & 0xFFFF), lv >> 16, off);
  const int reb = (is_lit || rd < 4 || rd == 28) ? 0 : (rd >> 2) - 1;
  place(lo, hi, is_lit ? 0u : run_extra, reb, off);
  const int dv = tab[288 + dd];
  place(lo, hi, is_lit ? 0u : static_cast<unsigned>(dv & 0xFFFF),
        is_lit ? 0 : dv >> 16, off);
  const int deb = (is_lit || dd < 4) ? 0 : (dd >> 1) - 1;
  place(lo, hi, is_lit ? 0u : dist_extra, deb, off);
  lo_out[t] = static_cast<int>(lo);
  hi_out[t] = static_cast<int>(hi);
  nb_out[t] = off;
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K6 on `stream`: terms (n,) i32, tabs (n / per_image, 320) i32 ->
// lo, hi, nbits (n,) i32.  per_image % 256 == 0, n % per_image == 0.
extern "C" int spt_emit(const void* terms, const void* tabs, void* lo,
                        void* hi, void* nb, long long n, int per_image,
                        void* stream) {
  if (n <= 0) return 0;
  if (per_image <= 0 || per_image % kThreads || n % per_image)
    return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<static_cast<unsigned>(n / kThreads), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(terms), static_cast<const int*>(tabs),
      static_cast<int*>(lo), static_cast<int*>(hi), static_cast<int*>(nb), n,
      per_image);
  return static_cast<int>(cudaGetLastError());
}
