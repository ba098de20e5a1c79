// sharp_yuv: the sharp RGB -> YUV 4:2:0 conversion's sweep loop, up to
// four Gauss-Seidel sweeps over the row pairs of each image with the
// per-image divergence exit, in place over int32 planes.
//
// Replaces sjpeg_tpu/sharp_yuv_device.py _sharp_core's lax.while_loop of
// _sharp_iteration's lax.scan (:135-204), which XLA compiles into one
// device loop; there is no Pallas kernel for it.  In eager PyTorch the
// same loop is ~100 launches a row pair, some 200,000 for a 1024^2 batch.
//
// Bound on the H100: the dependent chain, not bytes.  Each row pair reads
// the row above as updated by the previous pair, so an image is a chain of
// h/2 pairs x up to 4 sweeps (1,536 steps at 1024^2 over 3 sweeps, 3,024
// on a 12-MP photo over 2); a sweep reads and writes ~21 bytes a pixel,
// ~0.1 ms a sweep at 3.35 TB/s for 16 x 1024^2.  A step's time is what
// counts, and how many SMs share an image's columns.
//
// Design: a thread-block cluster of C CTAs an image (C in 1, 2, 4, 8, 16:
// the largest with B C <= the SM count and >= 32 chroma columns a CTA,
// raised until a CTA's slice is at most kMaxThreads x kMaxColsPerThread
// columns, lowered while cudaOccupancyMaxActiveClusters says it does not
// fit; a size the card refuses is an error).  Each CTA owns a contiguous
// slice of chroma columns, one a thread (up to four when the slice is
// wider than the CTA); its slice of the two-row ring of updated chroma
// lives in its shared memory beside the gamma tables.  A row pair is
// sharp_core.cuh's schedule: the chain-free loads two pairs ahead, the
// lower stage a pair ahead, the stores a pair late, all between the
// arrive and the wait of a split barrier over the CTA's threads (an
// mbarrier).  Between CTAs only the halo moves: a slice's first and last
// columns go to the neighbours' halo cells by st.async, each completing
// on the receiver's mbarrier, which the one thread that reads the cell
// waits on; a cluster barrier's release costs ~800 cycles a row pair,
// more than half the upper stage's chain.  The exit test sums the |luma
// error| over the cluster (int64, each CTA's sum read through distributed
// shared memory, after a cluster barrier that also orders the sweep's
// plane stores before the next sweep's loads), so every CTA takes the
// same decision with no host read.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SJ_SHARP_FN __device__ __forceinline__
#include "sharp_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxColsPerThread = 4;
constexpr int kMaxCluster = 16;
constexpr int kMinClusterCols = 32;
constexpr int kTableWords =
    sjpeg::kGammaToLinearSize + sjpeg::kLinearToGammaSize;
constexpr int kRingOffset = (kTableWords + 3) & ~3;   // 16-byte cells
// The dynamic shared memory of the widest slice: tables and two ring slots
constexpr int kMaxSmem =
    (kRingOffset + 2 * (kMaxThreads * kMaxColsPerThread + 2) * 4) * 4;
// A barrier wait that spins this often (seconds) traps: the launch fails
// instead of hanging the card.
constexpr uint32_t kMaxSpins = 1u << 24;

struct Plan {
  int cluster, threads, cols, cols_per_thread;
  size_t smem;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of the same shared-memory location in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Arms a halo barrier for its next cell: one arrival and 16 bytes.
__device__ __forceinline__ void arm(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], 16;"
               "\n\t}" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// The policy of sharp_core.cuh for one CTA of an image's cluster.  Ring
// cells are 4 words (one 16-byte remote store); the slice is [2][cols + 2]
// cells, the first and last of each slot the halo cells that the left and
// right neighbours fill.  bars[0] is the CTA's split barrier, bars[1 + s]
// and bars[3 + s] complete when the left and the right neighbour's cell of
// ring slot s has arrived; the thread that reads a halo cell waits on its
// barrier, then arms it for its next use (one arrival and 16 bytes).
template <int CPT>
struct ClusterCta {
  int j0, j1, cols;              // this CTA's columns [j0, j1), slice width
  int32_t* slice;                // own ring slice, shared
  uint64_t* bars;                // [5] shared
  uint32_t to_left, to_right;    // the neighbours' slices, shared::cluster
  uint32_t left_bar, right_bar;  // their bars[3] and bars[1], ditto
  int64_t* red;                  // [34] shared
  uint64_t token;                // this thread's arrival at bars[0]
  uint32_t parity;               // bit 2 side + slot: the halo phases waited
  uint32_t sums;                 // sum() calls so far
  sjpeg::SharpColumn col[CPT];

  template <class F>
  __device__ __forceinline__ void columns(F&& f) {
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int j = j0 + threadIdx.x + s * blockDim.x;
      if (j < j1) f(j, col[s]);
    }
  }
  __device__ __forceinline__ void arrive() {
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
                 : "=l"(token) : "r"(smem_addr(bars)) : "memory");
  }
  __device__ __forceinline__ void wait() {
    uint32_t done;
    for (uint32_t spins = 0;; ++spins) {
      asm volatile("{\n\t.reg .pred p;\n\t"
                   "mbarrier.try_wait.shared::cta.b64 p, [%1], %2;\n\t"
                   "selp.u32 %0, 1, 0, p;\n\t}"
                   : "=r"(done) : "r"(smem_addr(bars)), "l"(token)
                   : "memory");
      if (done) break;
      if (spins > kMaxSpins) __trap();
    }
  }
  __device__ __forceinline__ void sync() {
    arrive();
    wait();
  }
  __device__ __forceinline__ int32_t* cell(int slot, int idx) {
    return slice + (slot * (cols + 2) + idx) * 4;
  }
  __device__ __forceinline__ void send(uint32_t to, uint32_t bar,
                                       const int32_t v[3]) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
        "[%0], {%1, %2, %3, %4}, [%5];"
        :: "r"(to), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(0), "r"(bar)
        : "memory");
  }
  __device__ __forceinline__ void put(int slot, int j, const int32_t v[3]) {
    int32_t* own = cell(slot, j - j0 + 1);
    for (int c = 0; c < 3; ++c) own[c] = v[c];
    const uint32_t at = (uint32_t)(slot * (cols + 2)) * 16;
    if (j == j0 && to_left)
      send(to_left + at + (cols + 1) * 16, left_bar + slot * 8, v);
    if (j == j1 - 1 && to_right) send(to_right + at, right_bar + slot * 8, v);
  }
  __device__ __forceinline__ const int32_t* halo(int slot, int j) {
    if (j < j0 || j >= j1) {
      const int side = j < j0 ? 0 : 1;
      const uint32_t bar = smem_addr(bars + 1 + 2 * side + slot);
      const uint32_t bit = 1u << (2 * side + slot);
      uint32_t done;
      for (uint32_t spins = 0;; ++spins) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta"
                     ".b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"((parity & bit) ? 1u : 0u)
                     : "memory");
        if (done) break;
        if (spins > kMaxSpins) __trap();
      }
      parity ^= bit;
      arm(bar);
    }
    return cell(slot, j - j0 + 1);
  }
  __device__ int64_t sum(int64_t v) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    // The CTA totals alternate between red[32] and red[33]: between sums
    // the CTAs wait only for their neighbours, so one may finish the next
    // sweep while another still reads this sum; it cannot pass the next
    // sum's barrier before that read.
    int64_t* mine = red + 32 + (sums++ & 1);
    if (threadIdx.x == 0) {
      int64_t total = 0;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += red[i];
      *mine = total;
    }
    cluster_sync();                  // every CTA's total and plane store
    cg::cluster_group cluster = cg::this_cluster();
    int64_t total = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      total += *cluster.map_shared_rank(mine, r);
    return total;
  }
};

// Fills the gamma tables, the barriers and cta's fields, syncs the cluster
// and returns this CTA's image.
template <int CPT>
__device__ __forceinline__ sjpeg::SharpImage setup(
    ClusterCta<CPT>& cta, int32_t* smem, int64_t* red, uint64_t* bars,
    int32_t* y, int32_t* uv, const int32_t* ty, const int32_t* tuv,
    const int32_t* g2l, const int32_t* l2g, int w, int h, int cols) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    smem[i] = i < sjpeg::kGammaToLinearSize
                  ? g2l[i]
                  : l2g[i - sjpeg::kGammaToLinearSize];
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bars)), "r"(blockDim.x) : "memory");
    for (int i = 1; i < 5; ++i) {        // armed for the first halo cells
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + i)) : "memory");
      arm(smem_addr(bars + i));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int uv_w = w >> 1;
  const int j0 = rank * cols;
  const bool left = rank > 0 && j0 < uv_w;
  const bool right = j0 + cols < uv_w;
  cta.j0 = j0;
  cta.j1 = min(j0 + cols, uv_w);
  cta.cols = cols;
  cta.slice = smem + kRingOffset;
  cta.bars = bars;
  cta.to_left = left ? map_rank(smem_addr(cta.slice), rank - 1) : 0u;
  cta.to_right = right ? map_rank(smem_addr(cta.slice), rank + 1) : 0u;
  cta.left_bar = left ? map_rank(smem_addr(bars + 3), rank - 1) : 0u;
  cta.right_bar = right ? map_rank(smem_addr(bars + 1), rank + 1) : 0u;
  cta.red = red;
  cta.parity = 0;
  cta.sums = 0;
  cluster_sync();      // every CTA runs, its tables and barriers in place
  const int64_t b = blockIdx.x / cluster.num_blocks();
  const int64_t plane = (int64_t)w * h;
  return {y + b * plane, uv + b * (plane / 4) * 3, ty + b * plane,
          tuv + b * (plane / 4) * 3, w, h};
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
sharp_cluster_kernel(int32_t* y, int32_t* uv, const int32_t* ty,
                     const int32_t* tuv, const int32_t* g2l,
                     const int32_t* l2g, int32_t* iters, int w, int h,
                     int cols) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int64_t red[34];
  __shared__ uint64_t bars[5];
  ClusterCta<CPT> cta;
  const sjpeg::SharpImage im = setup(cta, smem, red, bars, y, uv, ty, tuv,
                                     g2l, l2g, w, h, cols);
  const int it = sjpeg::sharp_image(
      cta, sjpeg::SharpTables{smem, smem + sjpeg::kGammaToLinearSize}, im);
  cluster_sync();      // no CTA leaves while another reads its total
  if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0)
    iters[blockIdx.x / cg::this_cluster().num_blocks()] = it;
}

template <int CPT>
cudaError_t prepare(const Plan& p, cudaLaunchConfig_t& cfg,
                    cudaLaunchAttribute* attr, int b, cudaStream_t stream) {
  auto* kernel = sharp_cluster_kernel<CPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && p.smem > 48 * 1024 - 34 * 8 - 5 * 8)
    e = cudaFuncSetAttribute(   // the same value always: threads may race
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  cfg = {};
  cfg.gridDim = dim3((unsigned)(b * p.cluster));
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return e;
}

// The plan for b images of w x h: cluster size, threads, the slice width
// and the shared memory a CTA; cudaOccupancyMaxActiveClusters caps the
// cluster.  Returns a CUDA error code.
cudaError_t make_plan(int b, int w, int h, Plan& p) {
  if (b <= 0 || w < 6 || h < 6 || (w | h) & 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int uv_w = w >> 1;
  const int max_cols = kMaxThreads * kMaxColsPerThread;
  int fit = 1;                            // the least C whose slices fit
  while ((uv_w + fit - 1) / fit > max_cols) fit *= 2;
  if (fit > kMaxCluster) return cudaErrorInvalidValue;
  int c = kMaxCluster;
  while (c > fit && ((int64_t)b * c > sms || uv_w < kMinClusterCols * c))
    c >>= 1;
  for (;; c >>= 1) {
    p.cluster = c;
    p.cols = (uv_w + c - 1) / c;
    p.threads = p.cols < kMaxThreads ? (p.cols + 31) / 32 * 32 : kMaxThreads;
    p.cols_per_thread = (p.cols + p.threads - 1) / p.threads;
    p.smem = (kRingOffset + (size_t)2 * (p.cols + 2) * 4) * sizeof(int32_t);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    int fits = 0;
    e = p.cols_per_thread == 1
            ? prepare<1>(p, cfg, attr, b, nullptr)
            : prepare<kMaxColsPerThread>(p, cfg, attr, b, nullptr);
    if (e == cudaSuccess)
      e = p.cols_per_thread == 1
              ? cudaOccupancyMaxActiveClusters(
                    &fits, sharp_cluster_kernel<1>, &cfg)
              : cudaOccupancyMaxActiveClusters(
                    &fits, sharp_cluster_kernel<kMaxColsPerThread>, &cfg);
    if (e != cudaSuccess) return e;
    if (fits > 0) return cudaSuccess;
    if (c == fit) return cudaErrorInvalidConfiguration;   // never C = 1 quietly
  }
}

}  // namespace

// The launch plan of sjpeg_sharp_yuv for b images of w x h: out[0] the
// cluster size, out[1] the threads a CTA, out[2] the chroma columns a CTA,
// out[3] the columns a thread, out[4] the dynamic shared memory a CTA in
// bytes (the tables and the ring slice).  Returns a CUDA error code.
extern "C" int sjpeg_sharp_yuv_plan(int b, int w, int h, int* out) {
  Plan p;
  const cudaError_t e = make_plan(b, w, h, p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.cluster;
  out[1] = p.threads;
  out[2] = p.cols;
  out[3] = p.cols_per_thread;
  out[4] = (int)p.smem;
  return 0;
}

// y, ty [b, h, w]; uv, tuv [b, h/2, w/2, 3]; int32, w and h even and >= 6.
// y and uv are updated in place; iters [b] int32 gets each image's sweep
// count.  g2l [1024] and l2g [34] are the gamma tables.  Launches one
// cluster an image on `stream` and returns the CUDA error code.
extern "C" int sjpeg_sharp_yuv_cluster(void* y, void* uv, const void* ty,
                                       const void* tuv, const void* g2l,
                                       const void* l2g, void* iters, int b,
                                       int w, int h, void* stream) {
  if (b <= 0) return 0;
  Plan p;
  cudaError_t e = make_plan(b, w, h, p);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (p.cols_per_thread == 1) {
    e = prepare<1>(p, cfg, attr, b, (cudaStream_t)stream);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, sharp_cluster_kernel<1>, (int32_t*)y,
                             (int32_t*)uv, (const int32_t*)ty,
                             (const int32_t*)tuv, (const int32_t*)g2l,
                             (const int32_t*)l2g, (int32_t*)iters, w, h,
                             p.cols);
  } else {
    e = prepare<kMaxColsPerThread>(p, cfg, attr, b, (cudaStream_t)stream);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, sharp_cluster_kernel<kMaxColsPerThread>,
                             (int32_t*)y, (int32_t*)uv, (const int32_t*)ty,
                             (const int32_t*)tuv, (const int32_t*)g2l,
                             (const int32_t*)l2g, (int32_t*)iters, w, h,
                             p.cols);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
