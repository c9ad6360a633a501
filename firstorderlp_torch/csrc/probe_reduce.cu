// probe_reduce: y[strip, hi[r, l], lo[r, l]] += g[r, l] * v[r, l] over
// the 1024 entries of every group of the strip, in f32, starting from
// zero. The slots inside a strip are random and collide.
//
// Replaces the probe's reduce prototype of the JAX package (make_reduce /
// _reduce_kernel, benchmarking/probe_routed.py:129,99). The TPU kernel
// scatters with one-hot matrix products into an output block that stays
// in fast memory while the sequential grid walks the strip's groups. On
// Hopper blocks run in no order and nothing carries over between them,
// so the work is cut in two:
//
// 1. probe_reduce_chunks. The host cuts each strip's run of groups into
//    chunks (ops/probe_routed.py, plan_probe_reduce), about eight per SM.
//    One warp sums its chunk into a strip in shared memory (HR * 128
//    f32, 16 KB at HR = 32) and writes it out as a partial strip.
// 2. probe_reduce_combine. Every output slot adds its strip's partials
//    in chunk order; a strip that no group hits has no chunk and comes
//    out zero.
//
// No atomics, neither global nor shared: the order of every sum is
// fixed, so two launches give the same bits. A block is one warp, and it
// owns its whole strip, so no two warps ever touch the same slot. The
// warp takes 32 entries at a time in index order, one per lane, straight
// from device memory (each array in 128-byte rows, four steps loaded
// ahead). Two lanes of a step may hold the same slot (about one step in
// eight at 4096 slots). To see it, every lane writes its lane number to
// a byte per slot and reads it back: a lane that reads another number
// has lost the slot to a lane of the same step. If no lane lost, all
// slots of the step differ and every lane adds its product to its slot.
// Otherwise the lanes add one after the other in lane order. Which lane
// wins the byte is arbitrary, but it only picks between two ways that
// give the same sum: a slot's products are always added in entry order
// inside a group, group order inside a chunk and chunk order inside a
// strip.
//
// hi and lo are taken as given, unsorted. An entry whose hi or lo lies
// outside the strip is dropped.
//
// Bound on an H100 SXM: bytes (g, v, hi, lo: 16 bytes an entry; the
// output once); two operations an entry.

#include <cuda_runtime.h>

namespace folp {

constexpr int kGroupEntries = 1024;  // 8 rows of 128 entries
constexpr int kStepsAhead = 4;       // steps of 32 entries loaded together
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kGroupEntries % (32 * kStepsAhead) == 0,
              "a group is a whole number of batches of steps");

__device__ __forceinline__ int slot_of(int hi, int lo, int hr) {
  // an entry outside the strip has no slot
  return ((unsigned)hi < (unsigned)hr && (unsigned)lo < 128u)
             ? hi * 128 + lo
             : -1;
}

__global__ void __launch_bounds__(32)
    probe_reduce_chunks(const int* __restrict__ chunk_ptr,
                        const float* __restrict__ g,
                        const float* __restrict__ v,
                        const int* __restrict__ hi,
                        const int* __restrict__ lo, float* __restrict__ parts,
                        int hr) {
  extern __shared__ __align__(16) float smem[];
  const int strip_len = hr * 128;
  float* acc = smem;  // (hr, 128)
  unsigned char* tag = reinterpret_cast<unsigned char*>(acc + strip_len);
  const int lane = threadIdx.x;
  for (int i = lane; i < strip_len; i += 32) acc[i] = 0.f;
  __syncwarp();

  const size_t e_end = (size_t)chunk_ptr[blockIdx.x + 1] * kGroupEntries;
  for (size_t base = (size_t)chunk_ptr[blockIdx.x] * kGroupEntries;
       base < e_end; base += 32 * kStepsAhead) {
    int slot[kStepsAhead];
    float p[kStepsAhead];
#pragma unroll
    for (int k = 0; k < kStepsAhead; ++k) {
      const size_t e = base + 32 * k + lane;
      slot[k] = slot_of(hi[e], lo[e], hr);
      p[k] = g[e] * v[e];
    }
#pragma unroll
    for (int k = 0; k < kStepsAhead; ++k) {
      const bool has = slot[k] >= 0;
      if (has) tag[slot[k]] = (unsigned char)lane;
      __syncwarp();
      const bool lost = has && tag[slot[k]] != lane;
      if (__any_sync(kFullMask, lost)) {
        for (int l = 0; l < 32; ++l) {
          if (lane == l && has) acc[slot[k]] += p[k];
          __syncwarp();
        }
      } else {
        if (has) acc[slot[k]] += p[k];
        __syncwarp();  // before the next step writes tag and acc
      }
    }
  }
  float* out = parts + (size_t)blockIdx.x * strip_len;
  for (int i = lane; i < strip_len; i += 32) out[i] = acc[i];
}

__global__ void probe_reduce_combine(const int* __restrict__ strip_chunk_ptr,
                                     const float* __restrict__ parts,
                                     float* __restrict__ y, int strip_len) {
  const int strip = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= strip_len) return;
  float sum = 0.f;
  const int c_end = strip_chunk_ptr[strip + 1];
  for (int c = strip_chunk_ptr[strip]; c < c_end; ++c) {
    sum += parts[(size_t)c * strip_len + i];
  }
  y[(size_t)strip * strip_len + i] = sum;
}

}  // namespace folp

// chunk_ptr: (nchunks + 1,) first group of each chunk, every chunk inside
// one strip; strip_chunk_ptr: (n_strips + 1,) first chunk of each strip;
// g, v, hi, lo: (ngroups * 8, 128); parts: (nchunks, hr, 128) scratch;
// y: (n_strips, hr, 128). Returns the CUDA error code of the launches.
extern "C" int folp_probe_reduce(const int* chunk_ptr,
                                 const int* strip_chunk_ptr, const float* g,
                                 const float* v, const int* hi, const int* lo,
                                 float* parts, float* y, int nchunks,
                                 int n_strips, int hr, void* stream_ptr) {
  using namespace folp;
  if (n_strips <= 0) return 0;
  if (hr <= 0 || nchunks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int strip_len = hr * 128;
  if (nchunks > 0) {
    // the strip's sums, and a byte per slot
    const size_t bytes = (sizeof(float) + 1) * (size_t)strip_len;
    if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
    // Above 48 KB a block's shared memory must be asked for.
    cudaError_t err = cudaFuncSetAttribute(
        probe_reduce_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    probe_reduce_chunks<<<nchunks, 32, bytes, stream>>>(chunk_ptr, g, v, hi,
                                                        lo, parts, hr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((strip_len + 255) / 256, n_strips);
  probe_reduce_combine<<<grid, 256, 0, stream>>>(strip_chunk_ptr, parts, y,
                                                strip_len);
  return (int)cudaGetLastError();
}
