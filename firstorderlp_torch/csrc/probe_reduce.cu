// probe_reduce: y[strip, hi[r, l], lo[r, l]] += g[r, l] * v[r, l] over
// the 1024 entries of every group of the strip, in f32, starting from
// zero. The slots inside a strip are random and collide.
//
// Replaces the probe's reduce prototype of the JAX package (make_reduce /
// _reduce_kernel, benchmarking/probe_routed.py:129,99). The TPU kernel
// scatters with one-hot matrix products into an output block that stays
// in fast memory while the sequential grid walks the strip's groups. On
// Hopper blocks run in no order and nothing carries over between them,
// so the strip's sum is cut across blocks and put together again behind
// an integer ticket, in one launch:
//
// - Chunks. The host cuts each strip's run of groups into chunks of
//   about equal size, about one a SM in all (ops/probe_routed.py,
//   plan_probe_reduce); a strip that no group names gets one empty chunk,
//   so every strip has a block that writes it. The table `chunks` holds
//   four int32 a chunk: first group, strip, first chunk of the strip,
//   chunks of the strip; and a sentinel row whose first group is the
//   number of groups.
// - One block of `warps` warps a chunk. Each warp keeps its own copy of
//   the strip in shared memory (HR * 128 f32, 16 KB at HR = 32, and a
//   tag byte a slot) and walks a contiguous share of the chunk's steps
//   of 128 entries, one 16-byte load of each of g, v, hi and lo a lane,
//   the next step's loads in flight while it adds this one's. Inside a
//   step a lane adds its four entries one after the other, the 32 lanes
//   together. Two lanes may hold the same slot (about one add in eight
//   at 4096 slots): every lane writes its lane number to the slot's tag
//   byte and reads it back, and a lane that reads another number has
//   lost the slot. If no lane lost, every lane adds its product to its
//   slot. Otherwise the losers write a mark to their slots' bytes, and
//   the lanes of a marked slot (usually two) add one after the other in
//   lane order while the others add at once. Which lane wins the byte
//   is arbitrary, but it only picks between two ways that give the same
//   sum.
// - The block adds its warps' copies in warp order. A strip of one chunk
//   is then complete and is written to y. The chunks of a split strip
//   write their partial strips to `scratch` (slot = chunk) and draw an
//   integer ticket of the strip's counter; the block that draws the last
//   one adds the strip's partials in chunk order and writes y, and sets
//   the counter back to zero for the next launch.
//
// So a slot's products are always added in one order: the lanes' entries
// in (entry of the lane, lane) order inside a step, step order inside a
// warp's share, warp order inside a chunk, chunk order inside a strip.
// No floating-point atomics, neither global nor shared: two launches give
// the same bits. hi and lo are taken as given, unsorted; an entry whose
// hi or lo lies outside the strip is dropped.
//
// Bound on an H100 SXM: bytes (g, v, hi, lo: 16 bytes an entry; the
// output once); two operations an entry. Beyond those the kernel moves
// the partial strips of split strips, written once and read once (16 KB
// each at HR = 32), and the chunk table.

#include <cuda_runtime.h>

#include "fixed_order.cuh"

namespace folp {

constexpr int kGroupSteps = 8;  // a group is 1024 entries: 8 steps of 128
constexpr int kMaxReduceWarps = 11;  // 11 copies of 20 KB fit 227 KB

__device__ __forceinline__ int slot_of(int hi, int lo, int hr) {
  // an entry outside the strip has no slot
  return ((unsigned)hi < (unsigned)hr && (unsigned)lo < 128u)
             ? hi * 128 + lo
             : -1;
}

// One step of a warp: entries 4 lane .. 4 lane + 3 of its 128.
struct ReduceStep {
  float4 g, v;
  int4 hi, lo;
};

__device__ __forceinline__ ReduceStep load_step(const float4* g,
                                                const float4* v,
                                                const int4* hi,
                                                const int4* lo, int step,
                                                int step_end, int lane) {
  ReduceStep t{};
  if (step < step_end) {
    const size_t q = (size_t)step * 32 + lane;
    t.g = __ldg(g + q);
    t.v = __ldg(v + q);
    t.hi = __ldg(hi + q);
    t.lo = __ldg(lo + q);
  }
  return t;
}

// Every lane of the warp adds one product to its slot of `acc` (slot -1:
// none), in lane order where two lanes hold the same slot.
__device__ __forceinline__ void add_products(float* acc, unsigned char* tag,
                                             int slot, float prod,
                                             int lane) {
  const bool has = slot >= 0;
  if (has) tag[slot] = (unsigned char)lane;
  __syncwarp();
  const bool lost = has && tag[slot] != lane;
  if (__any_sync(kFullMask, lost)) {
    // A lane that lost marks its slot, so every lane of a shared slot
    // sees the mark (no lane number is 0xFF); those add one after the
    // other in lane order, the others at once.
    __syncwarp();
    if (lost) tag[slot] = 0xFF;
    __syncwarp();
    const bool shared = has && tag[slot] == 0xFF;
    if (has && !shared) acc[slot] += prod;
    for (unsigned turn = __ballot_sync(kFullMask, shared); turn;
         turn &= turn - 1) {
      if (lane == __ffs(turn) - 1) acc[slot] += prod;
      __syncwarp();
    }
  } else {
    if (has) acc[slot] += prod;
  }
  __syncwarp();  // before the next add writes tag and acc
}

__global__ void __launch_bounds__(32 * kMaxReduceWarps)
    probe_reduce_kernel(const int* __restrict__ chunks,
                        const float4* __restrict__ g,
                        const float4* __restrict__ v,
                        const int4* __restrict__ hi,
                        const int4* __restrict__ lo,
                        float* __restrict__ scratch, int* tickets,
                        float* __restrict__ y, int hr) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int strip_len = hr * 128;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* acc = smem + (size_t)warp * strip_len;  // this warp's copy
  unsigned char* tag = reinterpret_cast<unsigned char*>(
                           smem + (size_t)warps * strip_len) +
                       (size_t)warp * strip_len;

  const int4 chunk = reinterpret_cast<const int4*>(chunks)[blockIdx.x];
  const int group_end = chunks[4 * (blockIdx.x + 1)];
  const int strip = chunk.y;
  const int nsplit = chunk.w;  // chunks of this strip

  // contiguous shares of the chunk's steps, in warp order
  const int s0 = chunk.x * kGroupSteps;
  const int steps = (group_end - chunk.x) * kGroupSteps;
  const int share = (steps + warps - 1) / warps;
  const int w_begin = s0 + min(share * warp, steps);
  const int w_end = s0 + min(share * (warp + 1), steps);
  ReduceStep cur = load_step(g, v, hi, lo, w_begin, w_end, lane);

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = lane; i < strip_len / 4; i += 32) {
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();
  for (int s = w_begin; s < w_end; ++s) {
    const ReduceStep next = load_step(g, v, hi, lo, s + 1, w_end, lane);
    add_products(acc, tag, slot_of(cur.hi.x, cur.lo.x, hr),
                 cur.g.x * cur.v.x, lane);
    add_products(acc, tag, slot_of(cur.hi.y, cur.lo.y, hr),
                 cur.g.y * cur.v.y, lane);
    add_products(acc, tag, slot_of(cur.hi.z, cur.lo.z, hr),
                 cur.g.z * cur.v.z, lane);
    add_products(acc, tag, slot_of(cur.hi.w, cur.lo.w, hr),
                 cur.g.w * cur.v.w, lane);
    cur = next;
  }
  __syncthreads();

  // the chunk's partial strip: the warps' copies in warp order
  const float4* copies = reinterpret_cast<const float4*>(smem);
  const int len4 = strip_len / 4;
  float4* out = reinterpret_cast<float4*>(y) + (size_t)strip * len4;
  float4* mine = reinterpret_cast<float4*>(scratch) + (size_t)blockIdx.x * len4;
  for (int i = tid; i < len4; i += threads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < warps; ++w) {
      const float4 c = copies[(size_t)w * len4 + i];
      sum.x += c.x;
      sum.y += c.y;
      sum.z += c.z;
      sum.w += c.w;
    }
    if (nsplit == 1) {
      out[i] = sum;
    } else {
      __stcg(mine + i, sum);
    }
  }
  if (nsplit == 1) return;
  if (!last_ticket(tickets + strip, nsplit, &flag)) return;

  // the strip's partials in chunk order
  const float4* parts =
      reinterpret_cast<const float4*>(scratch) + (size_t)chunk.z * len4;
  for (int i = tid; i < len4; i += threads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nsplit; ++k) {
      const float4 c = __ldcg(parts + (size_t)k * len4 + i);
      sum.x += c.x;
      sum.y += c.y;
      sum.z += c.z;
      sum.w += c.w;
    }
    out[i] = sum;
  }
}

}  // namespace folp

// chunks: (nchunks + 1, 4) the chunk table (above); g, v, hi, lo:
// (ngroups * 8, 128), 16-byte aligned; scratch: (nchunks, hr, 128);
// tickets: (n_strips,) int32, zero between launches; y: (n_strips, hr,
// 128), every strip named by a chunk. Returns the CUDA error code of the
// launch.
extern "C" int folp_probe_reduce(const int* chunks, const float* g,
                                 const float* v, const int* hi, const int* lo,
                                 float* scratch, int* tickets, float* y,
                                 int nchunks, int hr, int warps,
                                 void* stream_ptr) {
  using namespace folp;
  if (nchunks <= 0) return 0;
  if (hr <= 0 || warps < 1 || warps > kMaxReduceWarps) {
    return (int)cudaErrorInvalidValue;
  }
  // each warp's copy of the strip, and a tag byte a slot
  const size_t bytes = (sizeof(float) + 1) * (size_t)hr * 128 * warps;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  // Above 48 KB a block's shared memory must be asked for.
  cudaError_t err = cudaFuncSetAttribute(
      probe_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  probe_reduce_kernel<<<nchunks, 32 * warps, bytes,
                        (cudaStream_t)stream_ptr>>>(
      chunks, reinterpret_cast<const float4*>(g),
      reinterpret_cast<const float4*>(v), reinterpret_cast<const int4*>(hi),
      reinterpret_cast<const int4*>(lo), scratch, tickets, y, hr);
  return (int)cudaGetLastError();
}
