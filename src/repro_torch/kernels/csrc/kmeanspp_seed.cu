// k-means++ seeding of a pool in one launch for Hopper (sm_90a): all k - 1
// draws of a restart, each a sum of D(x)^2, a pick and a distance pass.
//
// Replaces: no TPU kernel. The JAX package seeds with jax.random.choice
// inside a jitted scan (src/repro/core/lloyd.py::kmeanspp_init); the port
// drew each pick on the host with torch.multinomial, one copy of the weights
// and one wait for the card a draw (163 a fit at k = 164). This kernel makes
// the picks on the card from exponentials drawn up front on the host from the
// same generator (core/lloyd.py), so the picks are multinomial's:
//
//   w_i = mind_i^2 (f64), S = sum w, p_i = w_i / max(S, 1e-30),
//   pick = argmax_i p_i / E[d][i]  (first index on ties, NaN the maximum),
//   mind_i = min(mind_i, e(y_i, y_pick)),
//
// e from the f32 rows with f64 differences and an f64 sum: sqrt(sum (y-c)^2)
// for l2, sum |y - c| for l1. The plain version is kernels/ref.py::
// kmeanspp_seed_ref (the same rule in torch, the sums in another order).
//
// Bound on an H100 SXM: latency. A draw over the 1,024 x 256 pool is 0.8 M
// f64 operations (about 25 ns of the card's f64 rate) and reads 1 MiB that
// need not leave the chip; what it costs is its dependency chain, a sum over
// the whole pool before the pick, the pick before the next distance pass,
// 163 times in a row.
//
// Design, and what it does about the bound:
//  * One thread-block cluster (8 CTAs, or 16 where the pool needs it) holds
//    the pool resident in its CTAs' shared memory, rows split in contiguous
//    runs; nothing else runs, so the launch is a single cluster of the grid.
//  * A draw is two cluster barriers. Each CTA sums its rows' w (a fixed tree)
//    into a slot of its shared memory; after the barrier every CTA reads the
//    slots over distributed shared memory in rank order, so all hold the same
//    S bit for bit, and each finds the best (q, index) of its rows into a
//    second slot; after the second barrier every CTA reduces the slots to the
//    same pick, copies its row from the owner's shared memory, and updates
//    mind for its rows (one warp a row, lanes over the columns, an f64
//    butterfly). A slot is rewritten only after a barrier that every reader
//    of its last value has passed.
//  * Rank 0 writes the picks and the centroids (the pool's rows, copied
//    exactly) and raises a flag where S is 0 or not finite, the draws where
//    multinomial would raise; the wrapper reads it once after the launch.
//  * Measured (NVIDIA H100 80GB HBM3, 700.00 W; 1,024 x 256 pool, k = 164): 1.39 ms
//    a launch in a traced ImageNet fit, 8.5 us a draw, against 47-53 ms for the
//    host's per-draw loop it replaced; the host's exponentials (about 5 ms) now
//    take most of a restart's seeding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // a CTA's dynamic shared memory on an H100
constexpr int CLUSTER_SIZES[2] = {8, 16};

// The values other CTAs read over distributed shared memory.
struct Slots {
  double sum;     // this CTA's sum of w
  double best_q;  // the best q of its rows
  int best_i;     // the global row of that q (INT32_MAX: none)
  int winner;     // this draw's pick, for the CTA's own threads
  double smax;    // max(S, 1e-30), for the CTA's own threads
};

// Scratch of the block reductions.
struct Scratch {
  double sum[WARPS];
  double q[WARPS];
  int i[WARPS];
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline int rows_per_cta(int n, int cluster) {
  return (n + cluster - 1) / cluster;
}

__host__ __device__ inline size_t head_bytes() {
  return align16(sizeof(Slots)) + align16(sizeof(Scratch));
}

size_t smem_bytes(int n, int m, int cluster) {
  const size_t rows = (size_t)rows_per_cta(n, cluster);
  return head_bytes() + align16(rows * sizeof(double)) + align16((size_t)m * sizeof(float)) +
         rows * (size_t)m * sizeof(float);
}

// Whether (qa, ia) comes before (qb, ib) in torch.argmax's order: NaN above
// every number, larger q first, the lower index on a tie.
__device__ inline bool better(double qa, int ia, double qb, int ib) {
  const bool na = isnan(qa), nb = isnan(qb);
  if (na || nb) return na && nb ? ia < ib : na;
  if (qa != qb) return qa > qb;
  return ia < ib;
}

// The best (q, i) of the warp's lanes, on every lane: the order is total, so
// the butterfly gives each lane the same pair.
__device__ inline void warp_best(double& q, int& i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const double oq = __shfl_xor_sync(FULL, q, s);
    const int oi = __shfl_xor_sync(FULL, i, s);
    if (better(oq, oi, q, i)) q = oq, i = oi;
  }
}

template <bool L1>
__global__ void __launch_bounds__(THREADS, 1)
    seed_kernel(const float* __restrict__ Y, const double* __restrict__ E, int64_t* picks,
                float* centroids, int* err, int n, int m, int k, int first) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rpc = rows_per_cta(n, csize);
  const int base = rank * rpc;
  const int rows = max(0, min(rpc, n - base));

  extern __shared__ __align__(16) unsigned char smem[];
  Slots* slots = reinterpret_cast<Slots*>(smem);
  Scratch* scratch = reinterpret_cast<Scratch*>(smem + align16(sizeof(Slots)));
  double* mind = reinterpret_cast<double*>(smem + head_bytes());
  float* crow = reinterpret_cast<float*>(smem + head_bytes() + align16(rpc * sizeof(double)));
  float* pool = crow + align16((size_t)m * sizeof(float)) / sizeof(float);

  for (int i = tid; i < rows * m; i += THREADS) pool[i] = Y[(size_t)base * m + i];
  cluster.sync();  // every CTA's rows are in place before any is read remotely

  int winner = first;
  for (int d = 0;; ++d) {
    // the pick's row, from its owner's shared memory
    const int owner = winner / rpc;
    const float* src = cluster.map_shared_rank(pool, owner) + (size_t)(winner - owner * rpc) * m;
    for (int j = tid; j < m; j += THREADS) {
      const float v = src[j];
      crow[j] = v;
      if (rank == 0) centroids[(size_t)d * m + j] = v;
    }
    if (rank == 0 && tid == 0) picks[d] = winner;
    __syncthreads();

    // mind = min(mind, e(y, c)): one warp a row, lanes over the columns
    for (int r = warp; r < rows; r += WARPS) {
      const float* y = pool + (size_t)r * m;
      double acc = 0.0;
      for (int j = lane; j < m; j += 32) {
        const double diff = (double)y[j] - (double)crow[j];
        acc = L1 ? acc + fabs(diff) : fma(diff, diff, acc);
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL, acc, s);
      if (lane == 0) {
        const double dist = L1 ? acc : sqrt(acc);
        const double old = mind[r];
        mind[r] = (d == 0 || isnan(dist) || dist < old) ? dist : old;
      }
    }
    if (d == k - 1) break;
    __syncthreads();

    // this draw's exponential of the thread's first row, read before the
    // barriers so its latency is not on the pick's path
    const double* e = E + (size_t)d * n + base;
    const double e_first = tid < rows ? e[tid] : 1.0;

    // this CTA's sum of w, in a fixed order
    double part = 0.0;
    for (int r = tid; r < rows; r += THREADS) part += __dmul_rn(mind[r], mind[r]);  // w, rounded
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(FULL, part, s);
    if (lane == 0) scratch->sum[warp] = part;
    __syncthreads();
    if (warp == 0) {
      const double v = lane < WARPS ? scratch->sum[lane] : 0.0;
      double total = 0.0;
      for (int w = 0; w < WARPS; ++w) total += __shfl_sync(FULL, v, w);
      if (lane == 0) slots->sum = total;
    }
    cluster.sync();  // A: every CTA's sum is in its slot

    if (warp == 0) {  // lane c reads rank c's slot; the sum runs in rank order
      const double v = lane < csize ? cluster.map_shared_rank(slots, lane)->sum : 0.0;
      double S = 0.0;
      for (int c = 0; c < csize; ++c) S += __shfl_sync(FULL, v, c);
      if (lane == 0) {
        slots->smax = 1e-30 > S ? 1e-30 : S;  // Python's max(S, 1e-30); NaN stays NaN
        if (rank == 0 && !(S > 0.0 && S < INFINITY)) *err = 1;
      }
    }
    __syncthreads();

    // the best q = (w / smax) / E of this CTA's rows
    const double smax = slots->smax;
    double bq = -INFINITY;
    int bi = INT32_MAX;
    for (int r = tid; r < rows; r += THREADS) {
      const double q = mind[r] * mind[r] / smax / (r == tid ? e_first : e[r]);
      if (better(q, base + r, bq, bi)) bq = q, bi = base + r;
    }
    warp_best(bq, bi);
    if (lane == 0) scratch->q[warp] = bq, scratch->i[warp] = bi;
    __syncthreads();
    if (warp == 0) {
      bq = lane < WARPS ? scratch->q[lane] : -INFINITY;
      bi = lane < WARPS ? scratch->i[lane] : INT32_MAX;
      warp_best(bq, bi);
      if (lane == 0) slots->best_q = bq, slots->best_i = bi;
    }
    cluster.sync();  // B: every CTA's best is in its slot

    if (warp == 0) {  // lane c reads rank c's slot
      bq = -INFINITY, bi = INT32_MAX;
      if (lane < csize) {
        const Slots* o = cluster.map_shared_rank(slots, lane);
        bq = o->best_q, bi = o->best_i;
      }
      warp_best(bq, bi);
      if (lane == 0) slots->winner = bi;
    }
    __syncthreads();
    winner = slots->winner;
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

using Kernel = void (*)(const float*, const double*, int64_t*, float*, int*, int, int, int, int);

cudaLaunchConfig_t launch_config(int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// The CTAs of the cluster that holds an (n, m) pool: the smallest of 8 and 16
// whose CTAs' shared memory holds their rows and of which the card can run
// one cluster, 0 where none does, or minus a CUDA error code.
int kmeanspp_seed_cluster(int n, int m) {
  for (int cluster : CLUSTER_SIZES) {
    const size_t smem = smem_bytes(n, m, cluster);
    if (smem > (size_t)MAX_SMEM) continue;
    cudaError_t err = prepare(seed_kernel<false>, smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cluster, smem, 0, &attr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, (const void*)seed_kernel<false>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    if (active > 0) return cluster;
  }
  return 0;
}

// Y (n, m) f32 pool, E (k - 1, n) f64 exponentials, first the first pick ->
// picks (k,) int64, centroids (k, m) f32 (the picked rows), err (1,) int32 set
// to 1 where a draw's sum of weights was 0 or not finite (err is not
// cleared). One cluster of `cluster` CTAs (kmeanspp_seed_cluster). Returns
// the CUDA error code of the launch.
int kmeanspp_seed_f32(const float* Y, const double* E, int64_t* picks, float* centroids, int* err,
                      int n, int m, int k, int first, int l1, int cluster, void* stream) {
  const Kernel kernel = l1 ? seed_kernel<true> : seed_kernel<false>;
  const size_t smem = smem_bytes(n, m, cluster);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, smem, (cudaStream_t)stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, Y, E, picks, centroids, err, n, m, k, first);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
