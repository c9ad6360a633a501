// probe_expand: g[r, l] = x_strips[strip_ids[r / 8], hi[r, l], lo[r, l]]
// for every stored entry, exact in f32.
//
// Replaces the probe's expand prototype of the JAX package (make_expand /
// _expand_kernel, benchmarking/probe_routed.py:64,42). The TPU kernel
// selects with two one-hot matrix products per 128 entries because a
// gather there is bound by index rate; Hopper gathers from shared memory,
// so the kernel keeps the contract (a group of 8 x 128 entries reads one
// strip of H x 128 values named by a sorted table of strip ids) and not
// the arithmetic. The result is bitwise the value that was stored.
//
// One block takes a run of consecutive groups. It stages the group's
// strip (H * 128 f32, 16 KB at H = 32) in shared memory with 16-byte
// loads and stages again only when the strip id changes: the ids are
// sorted, so most consecutive groups share their strip. Each thread then
// loads four consecutive hi and lo (16 bytes each), gathers four values
// and writes them as one 16-byte store.
//
// Bound on an H100 SXM: bytes. hi, lo and g move 12 bytes an entry, the
// strips and the ids once; no arithmetic beyond the address.
//
// An entry whose strip id, hi or lo lies outside the strips reads as 0
// (the wrapper does not scan the index arrays, which would cost a pass
// and a read-back of its own).

#include <cuda_runtime.h>

namespace folp {

constexpr int kExpandThreads = 256;
constexpr int kGroupEntries = 1024;  // 8 rows of 128 entries
static_assert(kGroupEntries == 4 * kExpandThreads,
              "a thread gathers four consecutive entries of a group");

__global__ void __launch_bounds__(kExpandThreads)
    probe_expand_kernel(const int* __restrict__ strip_ids,
                        const float* __restrict__ x_strips,
                        const int4* __restrict__ hi,
                        const int4* __restrict__ lo, float4* __restrict__ g,
                        int ngroups, int groups_per_block, int n_strips,
                        int h_rows) {
  extern __shared__ __align__(16) float xs[];
  const int strip_len = h_rows * 128;
  const int tid = threadIdx.x;
  const int g_begin = blockIdx.x * groups_per_block;
  const int g_end = min(g_begin + groups_per_block, ngroups);
  int staged = -1;
  for (int grp = g_begin; grp < g_end; ++grp) {
    const int sid = strip_ids[grp];  // the same for every thread
    const bool strip_ok = (unsigned)sid < (unsigned)n_strips;
    if (strip_ok && sid != staged) {
      __syncthreads();  // the last group's gathers are done
      const float4* src = reinterpret_cast<const float4*>(
          x_strips + (size_t)sid * strip_len);
      float4* dst = reinterpret_cast<float4*>(xs);
      for (int i = tid; i < strip_len / 4; i += kExpandThreads) {
        dst[i] = src[i];
      }
      __syncthreads();
      staged = sid;
    }
    const size_t e4 = (size_t)grp * (kGroupEntries / 4) + tid;
    const int4 h = hi[e4];
    const int4 l = lo[e4];
    auto pick = [&](int hi_k, int lo_k) {
      const bool ok = strip_ok && (unsigned)hi_k < (unsigned)h_rows &&
                      (unsigned)lo_k < 128u;
      return ok ? xs[hi_k * 128 + lo_k] : 0.f;
    };
    g[e4] = make_float4(pick(h.x, l.x), pick(h.y, l.y), pick(h.z, l.z),
                        pick(h.w, l.w));
  }
}

}  // namespace folp

// hi, lo, g: (ngroups * 8, 128); x_strips: (n_strips, h, 128);
// strip_ids: (ngroups,). Returns the CUDA error code of the launch.
extern "C" int folp_probe_expand(const int* strip_ids, const float* x_strips,
                                 const int* hi, const int* lo, float* g,
                                 int ngroups, int n_strips, int h,
                                 int groups_per_block, void* stream_ptr) {
  using namespace folp;
  if (ngroups <= 0) return 0;
  if (h <= 0 || groups_per_block <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)h * 128;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  // Above 48 KB a block's shared memory must be asked for.
  cudaError_t err = cudaFuncSetAttribute(
      probe_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ngroups + groups_per_block - 1) / groups_per_block;
  probe_expand_kernel<<<blocks, kExpandThreads, bytes,
                        (cudaStream_t)stream_ptr>>>(
      strip_ids, x_strips, reinterpret_cast<const int4*>(hi),
      reinterpret_cast<const int4*>(lo), reinterpret_cast<float4*>(g),
      ngroups, groups_per_block, n_strips, h);
  return (int)cudaGetLastError();
}
