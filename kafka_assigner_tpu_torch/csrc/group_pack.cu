// KG1: the consumer-group orphan scan, hand-written for Hopper (sm_90a).
//
// Replaces: the `lax.scan` over `proc_order` in
// kafka_assigner_tpu/ops/assignment.py:1599-1621, inside K14 `pack_group`
// (:1552) and, through K15's vmap, `group_pack_sweep` (:1638). That is an
// XLA loop program, not a Pallas kernel. After sticky admission, each
// candidate s walks the rows in proc_order; a row that needs placing (a
// real row the sticky pass did not keep) goes to the alive consumer with
// the largest headroom that fits, ties to the lowest index; when nothing
// fits it goes to the largest-headroom consumer anyway and counts as
// overflow. Headroom is capacity - load, and -BIG for a dead consumer.
//
// The rule this kernel uses. Loads stay under 2^30 (groups/encode.py), so
// a live consumer's headroom stays above -BIG and a dead one sits at -BIG.
// Then the largest fitting headroom and the largest headroom belong to the
// same consumer whenever anything fits, so the pick is always the first
// argmax of headroom, and the row overflows when that maximum is below its
// weight. With no consumer alive every pick is consumer 0 and every row
// overflows; a dead consumer's headroom is never updated. The plain version
// (ops/group_pack.py:pack_scan_plain) runs the reference's step with its
// fits mask, and the tests hold the two together on ties and dead columns.
//
// What bounds it: a dependent chain of one warp argmax per orphan row, not
// bytes; step_probe_kernel below measures that chain's step alone. Step t+1's argmax needs step t's headroom update, so a candidate's
// orphan rows run one after another; the bytes (weights, need flags and
// assignments of the orphan rows, the loads) are a few MB at the largest
// shape, microseconds at 3.35 TB/s.
//
// What the design does about it:
// - One block of one warp per candidate, so the sweep's candidates run side
//   by side on the SMs and each chain is as short as its own orphan count.
// - Headroom, load and liveness sit in shared memory over C_pad. Lane l owns
//   consumers l, l + 32, ... and keeps its slice's (max, first index) in
//   registers. A step is one warp argmax in two hardware reductions
//   (__reduce_max_sync of the slice maxima, then __reduce_min_sync of the
//   first indices of the lanes that hold it: ties to the lower index); the
//   picking lane updates its one entry and rescans only its own slice.
// - The row stream is off the chain: each lane fetches one position of
//   proc_order two chunks ahead and that row's need flag and weight one
//   chunk ahead; a ballot of the need flags gives the chunk's orphan rows,
//   and rows that need nothing cost no step.
// - C_pad whose state exceeds the shared-memory opt-in limit runs the same
//   code on a global scratch of headroom (the caller's buffer) and on the
//   load tensor itself: slower, never a refusal.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t smem_bytes(int c) {
  // headroom and load (int32 each), then the liveness bytes.
  return static_cast<size_t>(c) * (2 * sizeof(int) + 1);
}

template <bool kShared>
__global__ void __launch_bounds__(kWarp) pack_scan_kernel(
    const int* __restrict__ weights,           // (S, P) scaled weights
    const int* __restrict__ capacities,        // (C,)
    const int* __restrict__ proc_order,        // (P,) a permutation of rows
    const unsigned char* __restrict__ alive,   // (S, C)
    const unsigned char* __restrict__ need,    // (S, P)
    int* __restrict__ assigned,                // (S, P) in/out
    int* __restrict__ load,                    // (S, C) in/out
    int* __restrict__ overflowed,              // (S,)
    int* __restrict__ scratch,                 // (S, C) global variant only
    int p, int c) {
  extern __shared__ int smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(s) * p;
  const size_t col0 = static_cast<size_t>(s) * c;

  int* hr;
  int* ld;
  const unsigned char* al;
  if (kShared) {
    hr = smem;
    ld = smem + c;
    unsigned char* al_s = reinterpret_cast<unsigned char*>(smem + 2 * c);
    for (int j = lane; j < c; j += kWarp) {
      ld[j] = load[col0 + j];
      al_s[j] = alive[col0 + j];
    }
    al = al_s;
  } else {
    hr = scratch + col0;
    ld = load + col0;
    al = alive + col0;
  }

  // Each lane's slice: headroom, and its (max, first index).
  int mv = INT_MIN, mi = INT_MAX;
  for (int j = lane; j < c; j += kWarp) {
    const int h = al[j] ? capacities[j] - ld[j] : -kBig;
    hr[j] = h;
    if (h > mv) {
      mv = h;
      mi = j;
    }
  }

  // The row stream: rows two chunks ahead, need flags and weights one ahead.
  // proc_order is a permutation of 0..P-1, so every fetched row is in range;
  // past the end a lane fetches row 0 and flags nothing.
  int row_next = lane < p ? proc_order[lane] : 0;
  int nd_next = lane < p ? need[row0 + row_next] : 0;
  int w_next = weights[row0 + row_next];
  int row_ahead = kWarp + lane < p ? proc_order[kWarp + lane] : 0;

  int over = 0;
  for (int base = 0; base < p; base += kWarp) {
    const int row_c = row_next;
    const int w_c = w_next;
    unsigned todo = __ballot_sync(kFull, nd_next != 0);
    const int pos = base + kWarp + lane;
    row_next = row_ahead;
    nd_next = pos < p ? need[row0 + row_next] : 0;
    w_next = weights[row0 + row_next];
    row_ahead = pos + kWarp < p ? proc_order[pos + kWarp] : 0;

    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int row = __shfl_sync(kFull, row_c, j);
      const int w = __shfl_sync(kFull, w_c, j);
      // The warp's argmax: the largest slice max, then the lowest first
      // index among the lanes that hold it.
      const int v = __reduce_max_sync(kFull, mv);
      const int i = __reduce_min_sync(kFull, mv == v ? mi : INT_MAX);
      over += v < w;
      if (lane == 0) assigned[row0 + row] = i;
      if (lane == (i & (kWarp - 1))) {
        ld[i] += w;
        if (al[i]) hr[i] -= w;
        mv = INT_MIN;
        mi = INT_MAX;
        for (int k = lane; k < c; k += kWarp) {
          const int h = hr[k];
          if (h > mv) {
            mv = h;
            mi = k;
          }
        }
      }
    }
  }

  if (kShared) {
    for (int j = lane; j < c; j += kWarp) load[col0 + j] = ld[j];
  }
  if (lane == 0) overflowed[s] = over;
}

// The step's floor, measured rather than assumed: one warp runs `steps`
// steps of the chain alone, one consumer a lane (C_pad 32, all alive): a
// step is the two warp reductions of pack_scan_kernel and the picking
// lane's bump of its headroom. With one consumer a lane the bump is the
// rescan, so the picks are KG1's own on that instance
// (ops/group_pack_cases.py:probe_picks emulates them). `in` holds the 32
// headrooms and the weight; `out` gets the last pick, the overflow count and
// the clock64 cycles of the loop.
__global__ void __launch_bounds__(kWarp) step_probe_kernel(
    const int* __restrict__ in, long long* out, long long steps) {
  const int lane = threadIdx.x;
  int mv = in[lane];
  const int w = in[kWarp];
  int i = -1, over = 0;
  const long long t0 = clock64();
#pragma unroll 4
  for (long long k = 0; k < steps; ++k) {
    const int v = __reduce_max_sync(kFull, mv);
    i = __reduce_min_sync(kFull, mv == v ? lane : INT_MAX);
    over += v < w;
    if (lane == i) mv -= w;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = i;
    out[1] = over;
    out[2] = t1 - t0;
  }
}

}  // namespace

extern "C" {

// The device's shared-memory opt-in limit per block, or -1.
int ka_group_pack_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return limit;
}

long long ka_group_pack_smem_bytes(int c) {
  return static_cast<long long>(smem_bytes(c));
}

// One launch: grid S blocks of one warp. use_global selects the variant
// that keeps headroom in `scratch` and updates `load` in place. Returns the
// cudaError_t of the launch.
int ka_group_pack_scan(const int* weights, const int* capacities,
                       const int* proc_order, const unsigned char* alive,
                       const unsigned char* need, int* assigned, int* load,
                       int* overflowed, int* scratch, int s, int p, int c,
                       int use_global, cudaStream_t stream) {
  if (s <= 0) return cudaSuccess;
  if (use_global) {
    pack_scan_kernel<false><<<s, kWarp, 0, stream>>>(
        weights, capacities, proc_order, alive, need, assigned, load,
        overflowed, scratch, p, c);
  } else {
    const size_t bytes = smem_bytes(c);
    if (bytes > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          pack_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    pack_scan_kernel<true><<<s, kWarp, bytes, stream>>>(
        weights, capacities, proc_order, alive, need, assigned, load,
        overflowed, scratch, p, c);
  }
  return cudaGetLastError();
}

// The step-floor probe (step_probe_kernel): `in` holds 33 int32 words on
// the device, `out` three int64 words.
int ka_group_pack_step_probe(const int* in, long long* out, long long steps,
                             cudaStream_t stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  step_probe_kernel<<<1, kWarp, 0, stream>>>(in, out, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
