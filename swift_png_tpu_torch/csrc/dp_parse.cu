// K5: min-cost LZ77 parse of each 1,024-byte chunk (the optimal parse).
//
// Replaces the Pallas kernel swift_png_tpu/ops/deflate_optimal.py
// _make_dp_kernel (launched by optimal_parse_device, once per iteration of
// _dp_iterated), which runs 128 chunks side by side on a tile's lanes.
//
// Per chunk of clen live bytes: cost[0] = 0, the rest INF.  At position i
// (in order), the literal edge i -> i+1 costs dep_lit[byte]; then for each
// of the two candidates (dist << 9 | run) the edges i -> i+L for L in
// 3..min(run, clen-i) cost ddep[decade(dist)] + runcost[L-3].  Every
// relaxation is strict '<', the literal first and candidate 0 before
// candidate 1, so ties resolve as on the TPU.  The backtrack from clen
// writes each term at its end position: 0xF8000000 | byte for a literal,
// dd << 27 | (dist - base) << 14 | (L - rbase) << 9 | 0x100 | rd for a
// match, sets valid there, and counts the symbols (lit/run rows 0..287,
// distance decades 288..317) into the image's 320-row histogram.
//
// One warp per chunk, four chunks (always of one image) per block; the
// block's cost tables sit in shared memory.  At position i, lane l relaxes
// lengths 3 + l, 35 + l, ... of one candidate: distinct targets, so no
// conflicts; a __syncwarp() separates the two candidates and the
// positions.  Each lane holds the bytes and candidates of one position of
// a 32-position window and hands them round with shuffles.  The backtrack
// is serial on lane 0; the histogram gathers in shared memory and goes out
// with one atomicAdd per non-zero row.
//
// What bounds it: the relaxations, a chain of clen dependent steps per
// chunk (up to 2 x 256 edges per step on long matches); its bytes (data,
// candidates, terms) are 14 per position.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NB = 1024;
constexpr int kWarps = 4;
constexpr int kRows = 320;
constexpr int INF = 1 << 28;

__device__ __forceinline__ int decade_of(int dist) {
  const int dm1 = dist - 1;
  int bl = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) bl += dm1 >= (1 << t);
  const int hi = (dm1 >> max(bl - 2, 0)) & 1;
  return dist <= 4 ? dm1 : 2 * (bl - 1) + hi;
}

__global__ void __launch_bounds__(kWarps * 32)
    dp_kernel(const uint8_t* __restrict__ data, const int* __restrict__ clens,
              const int* __restrict__ cand, const int* __restrict__ dep_lit,
              const int* __restrict__ runcost, const int* __restrict__ ddep,
              const int* __restrict__ rdinfo, const int* __restrict__ dbase,
              int* __restrict__ terms, uint8_t* __restrict__ valid,
              int* __restrict__ hist, long long ntot, int cpi) {
  __shared__ int cost_s[kWarps][NB + 1];
  __shared__ int prov_s[kWarps][NB + 1];   // plen | pdist << 9
  __shared__ int hist_s[kWarps][kRows];
  __shared__ int lit_t[256], run_t[256], rdi_t[256], dd_t[32], db_t[32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x * kWarps + warp;
  const int img = blockIdx.x * kWarps / cpi;
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    lit_t[k] = dep_lit[img * 256 + k];
    run_t[k] = runcost[img * 256 + k];
    rdi_t[k] = rdinfo[k];
  }
  if (threadIdx.x < 32) {
    dd_t[threadIdx.x] = ddep[img * 32 + threadIdx.x];
    db_t[threadIdx.x] = dbase[threadIdx.x];
  }
  int* cost = cost_s[warp];
  int* prov = prov_s[warp];
  int* hs = hist_s[warp];
  for (int k = lane; k <= NB; k += 32) {
    cost[k] = k == 0 ? 0 : INF;
    prov[k] = 1 << 9;
  }
  for (int k = lane; k < kRows; k += 32) hs[k] = 0;
  const long long cb = static_cast<long long>(chunk) * NB;
  for (int k = lane; k < NB; k += 32) {
    terms[cb + k] = 0;
    valid[cb + k] = 0;
  }
  __syncthreads();

  const int clen = clens[chunk];
  for (int w = 0; w < clen; w += 32) {
    const long long P = cb + w + lane;
    const int byte_l = data[P];
    const int lit_l = lit_t[byte_l];
    const int c0_l = cand[P];
    const int c1_l = cand[ntot + P];
    const int kend = min(32, clen - w);
    for (int k = 0; k < kend; ++k) {
      const int i = w + k;
      const int ci = cost[i];
      const int litc = __shfl_sync(0xFFFFFFFFu, lit_l, k);
      if (lane == 0) {
        const int lc = ci + litc;
        if (lc < cost[i + 1]) {
          cost[i + 1] = lc;
          prov[i + 1] = 1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int cv = __shfl_sync(0xFFFFFFFFu, kk == 0 ? c0_l : c1_l, k);
        const int dist = cv >> 9;
        const int reach = min(cv & 0x1FF, clen - i);
        if (reach >= 3) {
          const int dd = decade_of(dist);
          const int base =
              ci + ((dd >= 0 && dd < 32) ? dd_t[dd] : 0);
          for (int L = 3 + lane; L <= reach; L += 32) {
            const int news = base + run_t[L - 3];
            if (news < cost[i + L]) {
              cost[i + L] = news;
              prov[i + L] = (dist << 9) | L;
            }
          }
        }
        __syncwarp();
      }
    }
  }

  if (lane == 0) {
    int i = clen;
    while (i >= 1) {
      const int pr = prov[i];
      const int ln = pr & 0x1FF;
      if (ln == 0) break;
      const int dist = pr >> 9;
      int term;
      if (ln == 1) {
        const int byte = data[cb + i - 1];
        term = static_cast<int>(0xF8000000u | static_cast<unsigned>(byte));
        hs[byte] += 1;
      } else {
        const int rinfo = rdi_t[ln - 3];
        const int rd = rinfo & 31;
        const int rbase = (rinfo >> 5) & 0x1FF;
        const int dd = decade_of(dist);
        const int dbv = (dd >= 0 && dd < 32) ? db_t[dd] : 0;
        term = static_cast<int>(
            (static_cast<unsigned>(dd) << 27) |
            (static_cast<unsigned>(dist - dbv) << 14) |
            (static_cast<unsigned>(ln - rbase) << 9) | 0x100u |
            static_cast<unsigned>(rd));
        hs[257 + rd] += 1;
        if (dd >= 0 && dd < 32) hs[288 + dd] += 1;
      }
      terms[cb + i - 1] = term;
      valid[cb + i - 1] = 1;
      i -= ln;
    }
  }
  __syncwarp();
  for (int k = lane; k < kRows; k += 32)
    if (hs[k]) atomicAdd(hist + img * kRows + k, hs[k]);
}

}  // namespace

extern "C" const char* spt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch K5 on `stream`: data (C * 1024) u8, clen (C,) i32, cand (2, C*1024)
// i32, dep_lit/runcost (B, 256), ddep (B, 32), rdinfo (256,), dbase (32,)
// i32 -> terms (C*1024) i32, valid (C*1024) u8, hist (B, 320) i32 (zeroed
// by the caller).  cpi (chunks per image) % 4 == 0, C % cpi == 0.
extern "C" int spt_dp_parse(const void* data, const void* clen,
                            const void* cand, const void* dep_lit,
                            const void* runcost, const void* ddep,
                            const void* rdinfo, const void* dbase,
                            void* terms, void* valid, void* hist, int chunks,
                            int cpi, void* stream) {
  if (chunks <= 0) return 0;
  if (cpi <= 0 || cpi % kWarps || chunks % cpi)
    return static_cast<int>(cudaErrorInvalidValue);
  dp_kernel<<<chunks / kWarps, kWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(clen),
      static_cast<const int*>(cand), static_cast<const int*>(dep_lit),
      static_cast<const int*>(runcost), static_cast<const int*>(ddep),
      static_cast<const int*>(rdinfo), static_cast<const int*>(dbase),
      static_cast<int*>(terms), static_cast<uint8_t*>(valid),
      static_cast<int*>(hist), static_cast<long long>(chunks) * NB, cpi);
  return static_cast<int>(cudaGetLastError());
}
