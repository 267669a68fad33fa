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
// overflows; a dead consumer's headroom is never updated, its load is. The
// plain version (ops/group_pack.py:pack_scan_plain) runs the reference's
// step with its fits mask, and the tests hold the two together on ties,
// dead columns and every variant's boundaries.
//
// What bounds it: a dependent chain of one warp argmax per orphan row, not
// bytes. Step t+1's argmax needs step t's headroom update, so a candidate's
// orphan rows run one after another; the bytes (weights, need flags and
// assignments of the orphan rows, the loads) are a few MB at the largest
// shape, microseconds at 3.35 TB/s. step_probe_kernel below measures a step
// of two warp reductions and a bump alone: the yardstick of the chain.
//
// What the design does about it. One block per candidate, so the sweep's
// candidates run side by side on the SMs and each chain is as short as its
// own orphan count. Then three variants, chosen by C_pad and the device's
// shared-memory limit only (ops/group_pack.py:variant_of):
// - registers (C_pad <= 1,024), two warps. The chain warp's lane l holds
//   the headrooms of consumers l*K .. l*K + K - 1 in `int h[K]`, K in {1,
//   2, 4, 8, 16, 32}, the narrowest that holds the candidate's last live
//   consumer (below); slots past the consumers hold INT_MIN, below a dead
//   consumer's -BIG. A step is one __reduce_max_sync of the lanes' maxima
//   and a ballot of the lanes that hold it: slices are contiguous, so the
//   lowest such lane holds the first argmax, at its own first maximum.
//   While the reduction is in flight every lane takes its slice's best
//   slot but its maximum (an unrolled tree of DPX max-with-predicate,
//   ties to the lower slot; a runtime index into h[] would put it in local
//   memory), so the picking lane's new maximum is one compare of that
//   against its bumped slot, and the bump a predicated write over K slots.
//   The pick is stored by one predicated store; a live consumer's load is
//   its capacity less its headroom, written at the end; a dead one is
//   picked only when every headroom is -BIG, and then it is consumer 0,
//   whose load a register counts. K follows each candidate's data, not
//   C_pad: a consumer past the last live one is never the first argmax
//   (ops/group_pack.py:span_slots), so one kernel holds every K. The
//   producer warp walks proc_order four chunks of 32 at a time with all
//   their loads in flight, and appends the orphan rows' (row, weight) in
//   order to a ring in shared memory; the chain warp reads one entry a
//   step, so it never waits on a gather and rows that need nothing cost
//   it nothing.
// - shared (1,024 < C_pad, state within the opt-in limit), one warp:
//   headroom, load and liveness in shared memory, lane l owning consumers
//   l, l + 32, ... with its slice's (max, first index) in registers; a
//   step is two warp reductions (the max, then the lowest first index
//   holding it) and the picking lane's rescan of its slice. Its rows come
//   from a stream in registers: each lane fetches one position of
//   proc_order two chunks ahead and that row's need flag and weight one
//   chunk ahead, and a ballot of the need flags gives the chunk's orphans.
// - global (past the limit, or forced): the shared variant's code on a
//   global scratch of headroom (the caller's buffer) and on the load tensor
//   itself: slower, never a refusal.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr size_t kDefaultSmem = 48 * 1024;

// The variants of ka_group_pack_scan (ops/group_pack.py:VARIANTS).
enum Variant { kRegisters = 0, kShared = 1, kGlobal = 2 };

__host__ __device__ inline size_t smem_bytes(int c) {
  // headroom and load (int32 each), then the liveness bytes.
  return static_cast<size_t>(c) * (2 * sizeof(int) + 1);
}

// The shared and global variants' row stream: the orphan rows of candidate
// s, a chunk of 32 positions of proc_order at a time. proc_order is a permutation of 0..P-1, so every fetched row is in
// range; past the end a lane fetches row 0 and flags nothing.
struct RowStream {
  const int* weights;
  const int* order;
  const unsigned char* need;
  size_t row0;
  int p, lane;
  int row_next, nd_next, w_next, row_ahead;

  __device__ RowStream(const int* weights_, const int* order_,
                       const unsigned char* need_, size_t row0_, int p_,
                       int lane_)
      : weights(weights_), order(order_), need(need_), row0(row0_), p(p_),
        lane(lane_) {
    row_next = lane < p ? order[lane] : 0;
    nd_next = lane < p ? need[row0 + row_next] : 0;
    w_next = weights[row0 + row_next];
    row_ahead = kWarp + lane < p ? order[kWarp + lane] : 0;
  }

  // Moves to the chunk at `base`: this lane's row of it and that row's
  // weight; returns the ballot of the chunk's orphan rows, and issues the
  // next chunk's loads.
  __device__ unsigned advance(int base, int& row, int& w) {
    row = row_next;
    w = w_next;
    const unsigned todo = __ballot_sync(kFull, nd_next != 0);
    const int pos = base + kWarp + lane;
    row_next = row_ahead;
    nd_next = pos < p ? need[row0 + row_next] : 0;
    w_next = weights[row0 + row_next];
    row_ahead = pos + kWarp < p ? order[pos + kWarp] : 0;
    return todo;
  }
};

// (max, first slot) of v[0..K) in place into v[0], ix[0]: a tree over
// adjacent pairs, then pairs of pairs; a tie keeps the left, lower slot.
template <int K, int kStep = 1>
__device__ __forceinline__ void tree_max(int (&v)[K], int (&ix)[K]) {
  if constexpr (kStep < K) {
#pragma unroll
    for (int k = 0; k < K; k += 2 * kStep) {
      bool left;  // v[k] >= v[k + kStep], from the same DPX max
      v[k] = __vibmax_s32(v[k], v[k + kStep], &left);
      ix[k] = left ? ix[k] : ix[k + kStep];
    }
    tree_max<K, 2 * kStep>(v, ix);
  }
}

// (max, first slot) of h[0..K), leaving out slot `skip` (-1: none).
template <int K>
__device__ __forceinline__ void slice_max(const int (&h)[K], int skip, int& mv,
                                          int& mk) {
  int v[K], ix[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = k == skip ? INT_MIN : h[k];
    ix[k] = k;
  }
  tree_max<K>(v, ix);
  mv = v[0];
  mk = ix[0];
}

// *dst = v where `pred`, as one predicated store: no branch, so the warp
// stays converged on the chain (the compiler would branch around the
// address arithmetic, and reconverge every step).
__device__ __forceinline__ void store_if(bool pred, int* dst, int v) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %2, 0;\n\t"
      "@p st.global.b32 [%0], %1;\n\t}"
      :
      : "l"(dst), "r"(v), "r"(static_cast<int>(pred))
      : "memory");
}

// The register variant's orphan ring: (row, weight) of each orphan row in
// proc_order, written by the producer warp, read by the chain warp.
constexpr int kRing = 1024;  // entries, a power of two
constexpr int kProduce = 4;  // chunks of 32 positions the producer loads at once

struct Ring {
  int2 entry[kRing];
  int head;  // entries written (producer)
  int tail;  // entries consumed, published at each batch (chain warp)
  int done;  // the producer has written every orphan row
};

// The producer warp: walks proc_order kProduce chunks at a time, with every
// chunk's loads in flight at once, and appends the orphan rows to the ring
// in order (a ballot of the need flags and a prefix count per chunk).
__device__ void produce_orphans(const int* __restrict__ weights,
                                const int* __restrict__ order,
                                const unsigned char* __restrict__ need,
                                size_t row0, int p, int lane, Ring& ring) {
  volatile Ring& vr = ring;
  const unsigned below = (1u << lane) - 1;
  int head = 0, tail = 0;
  for (int base = 0; base < p; base += kProduce * kWarp) {
    int row[kProduce], nd[kProduce], w[kProduce];
#pragma unroll
    for (int u = 0; u < kProduce; ++u) {
      const int pos = base + u * kWarp + lane;
      row[u] = pos < p ? order[pos] : -1;
    }
#pragma unroll
    for (int u = 0; u < kProduce; ++u) {
      nd[u] = row[u] >= 0 ? need[row0 + row[u]] : 0;
      w[u] = row[u] >= 0 ? weights[row0 + row[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kProduce; ++u) {
      const unsigned mask = __ballot_sync(kFull, nd[u] != 0);
      const int n = __popc(mask);
      while (head + n - tail > kRing)  // wait for room
        tail = __shfl_sync(kFull, vr.tail, 0);
      if (nd[u]) {
        const int at = (head + __popc(mask & below)) & (kRing - 1);
        ring.entry[at] = make_int2(row[u], w[u]);
      }
      head += n;
    }
    __syncwarp();
    __threadfence_block();
    if (lane == 0) vr.head = head;
  }
  __syncwarp();
  __threadfence_block();
  if (lane == 0) vr.done = 1;
}

// The end of the chain warp's next batch of ring entries, from `t`: it
// publishes `t` as consumed, waits for the producer, and returns t when the
// producer has finished and nothing is left. A batch stops half a ring
// ahead, so the producer always has room to run on. Every lane takes lane
// 0's reads of `done` and `head`, so the warp runs one batch by
// construction, not by staying converged at the loads.
__device__ __forceinline__ int next_batch(volatile Ring& vr, int t) {
  vr.tail = t;
  for (;;) {
    const int done = __shfl_sync(kFull, vr.done, 0);
    const int head = __shfl_sync(kFull, vr.head, 0);
    if (head > t || done) {
      __threadfence_block();
      return min(head, t + kRing / 2);
    }
  }
}

// The inputs of one candidate's scan in the register variant.
struct Scan {
  const int* __restrict__ capacities;
  const unsigned char* __restrict__ alive;
  int* __restrict__ assigned;
  int* __restrict__ load;
  int* __restrict__ overflowed;
  size_t row0, col0;
  int s, c;
};

// The chain warp of the register variant at K consumers a lane, over the
// first `width` <= 32 K consumers (every live one among them).
template <int K>
__device__ __forceinline__ void scan_chain(const Scan& a, int width, Ring& ring,
                                           int lane) {
  const int* __restrict__ capacities = a.capacities;
  const unsigned char* __restrict__ alive = a.alive;
  int* __restrict__ assigned = a.assigned;
  int* __restrict__ load = a.load;
  const size_t row0 = a.row0, col0 = a.col0;
  const int c = width;
  // This lane's slice: consumers lane*K + k, their liveness bits, and the
  // slice's (max, first slot).
  int h[K];
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane * K + k;
    h[k] = INT_MIN;
    if (j < c) {
      const bool on = alive[col0 + j] != 0;
      h[k] = on ? capacities[j] - load[col0 + j] : -kBig;
      live |= static_cast<unsigned>(on) << k;
    }
  }
  int mv, mk;
  slice_max<K>(h, -1, mv, mk);

  const unsigned below = (1u << lane) - 1;  // the lanes under this one
  const bool alive0 = alive[col0] != 0;
  int over = 0, dead0 = 0;
  for (int t = 0;;) {
    const int end = next_batch(ring, t);
    if (end == t) break;
    for (; t < end; ++t) {
      const int2 e = ring.entry[t & (kRing - 1)];
      const int w = e.y;
      // The warp's argmax: the largest slice max, held first by the lowest
      // lane that holds it.
      const int v = __reduce_max_sync(kFull, mv);
      // While the reduction is in flight: the slice's best but its max
      // slot, which is what the slice holds after this lane's pick unless
      // the bumped slot stays on top. It needs neither the warp's answer
      // nor the weight.
      int sv, sk;
      slice_max<K>(h, mk, sv, sk);
      const bool top = mv == v;
      const unsigned tied = __ballot_sync(kFull, top);
      const bool mine = top && (tied & below) == 0;
      over += v < w;
      // A live pick's load is its capacity less its headroom, written at
      // the end. A dead one keeps its headroom at -BIG, so it is picked
      // only when every headroom is -BIG, and then it is consumer 0: its
      // load is counted here, alike in every lane.
      store_if(mine, assigned + row0 + e.x, lane * K + mk);
      dead0 += (v == -kBig && !alive0) ? w : 0;
      const bool bump = mine && ((live >> mk) & 1u);
      const int hm = mv - w;
#pragma unroll
      for (int k = 0; k < K; ++k) h[k] = (bump && k == mk) ? hm : h[k];
      const bool rest = sv > hm || (sv == hm && sk < mk);
      if (bump) {
        mv = rest ? sv : hm;
        mk = rest ? sk : mk;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane * K + k;
    if (j < c && ((live >> k) & 1u)) load[col0 + j] = capacities[j] - h[k];
  }
  if (lane == 0) {
    if (!alive0) load[col0] += dead0;
    a.overflowed[a.s] = over;
  }
}

// The narrowest bucket of at most K consumers a lane whose slices hold
// every live consumer (`span` columns from 0), then its chain. A consumer
// past the last live one sits at -BIG, as every dead one does, so it is
// never the first argmax while a consumer lives, and with none alive the
// pick is consumer 0: the picks are those over all C_pad columns.
template <int K>
__device__ __forceinline__ void scan_span(const Scan& a, int span, Ring& ring,
                                          int lane) {
  if constexpr (K > 1) {
    if (span <= kWarp * (K / 2)) {
      scan_span<K / 2>(a, span, ring, lane);
      return;
    }
  }
  scan_chain<K>(a, min(a.c, kWarp * K), ring, lane);
}

// The register variant's most consumers a lane: C_pad <= 32 * kMaxSlots.
constexpr int kMaxSlots = 32;

__global__ void __launch_bounds__(2 * kWarp) pack_scan_regs_kernel(
    const int* __restrict__ weights,           // (S, P) scaled weights
    const int* __restrict__ capacities,        // (C,)
    const int* __restrict__ proc_order,        // (P,) a permutation of rows
    const unsigned char* __restrict__ alive,   // (S, C)
    const unsigned char* __restrict__ need,    // (S, P)
    int* __restrict__ assigned,                // (S, P) in/out
    int* __restrict__ load,                    // (S, C) in/out
    int* __restrict__ overflowed,              // (S,)
    int p, int c) {
  __shared__ Ring ring;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const size_t row0 = static_cast<size_t>(s) * p;
  const size_t col0 = static_cast<size_t>(s) * c;
  if (threadIdx.x == 0) {
    ring.head = 0;
    ring.tail = 0;
    ring.done = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kWarp) {
    produce_orphans(weights, proc_order, need, row0, p, lane, ring);
    return;
  }
  // The candidate's live span: columns up to its last live consumer.
  int last = 0;
  for (int j = lane; j < c; j += kWarp)
    if (alive[col0 + j]) last = j;
  const int span = __reduce_max_sync(kFull, last) + 1;
  const Scan a{capacities, alive, assigned, load, overflowed, row0, col0, s, c};
  scan_span<kMaxSlots>(a, span, ring, lane);
}

template <bool kSharedState>
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
  if (kSharedState) {
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

  RowStream rows(weights, proc_order, need, row0, p, lane);
  int over = 0;
  for (int base = 0; base < p; base += kWarp) {
    int row_c, w_c;
    unsigned todo = rows.advance(base, row_c, w_c);
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

  if (kSharedState) {
    for (int j = lane; j < c; j += kWarp) load[col0 + j] = ld[j];
  }
  if (lane == 0) overflowed[s] = over;
}

// The step's yardstick, measured rather than assumed: one warp runs
// `steps` steps of a chain alone, one consumer a lane (C_pad 32, all
// alive): a step is two warp reductions (the max, then the lowest lane
// holding it) and the picking lane's bump of its headroom, so the picks
// are KG1's own on that instance (ops/group_pack_cases.py:probe_picks
// emulates them). `in` holds the 32 headrooms and the weight; `out` gets
// the last pick, the overflow count and the clock64 cycles of the loop.
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

// The register variant's yardstick: step_probe_kernel's chain with the
// register variant's step, one warp reduction and a ballot of the lanes
// holding the max (the lowest is the pick), then the bump. Its picks are
// step_probe_kernel's.
__global__ void __launch_bounds__(kWarp) ballot_probe_kernel(
    const int* __restrict__ in, long long* out, long long steps) {
  const int lane = threadIdx.x;
  int mv = in[lane];
  const int w = in[kWarp];
  int i = -1, over = 0;
  const long long t0 = clock64();
#pragma unroll 4
  for (long long k = 0; k < steps; ++k) {
    const int v = __reduce_max_sync(kFull, mv);
    i = __ffs(__ballot_sync(kFull, mv == v)) - 1;
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

// One launch: grid S blocks, in the variant the caller chose
// (ops/group_pack.py:variant_of): kRegisters (C <= 32 * kMaxSlots, two
// warps a block), kShared, or kGlobal, which keeps headroom in `scratch`
// and updates `load` in place (one warp). Returns the cudaError_t of the
// launch; a variant that does not fit C is cudaErrorInvalidValue.
int ka_group_pack_scan(const int* weights, const int* capacities,
                       const int* proc_order, const unsigned char* alive,
                       const unsigned char* need, int* assigned, int* load,
                       int* overflowed, int* scratch, int s, int p, int c,
                       int variant, cudaStream_t stream) {
  if (s <= 0) return cudaSuccess;
  if (variant == kRegisters) {
    if (c > kWarp * kMaxSlots) return (int)cudaErrorInvalidValue;
    pack_scan_regs_kernel<<<s, 2 * kWarp, 0, stream>>>(
        weights, capacities, proc_order, alive, need, assigned, load,
        overflowed, p, c);
  } else if (variant == kGlobal) {
    pack_scan_kernel<false><<<s, kWarp, 0, stream>>>(
        weights, capacities, proc_order, alive, need, assigned, load,
        overflowed, scratch, p, c);
  } else if (variant == kShared) {
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
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The step probe: step_probe_kernel, or with `ballot` ballot_probe_kernel.
// `in` holds 33 int32 words on the device, `out` three int64 words.
int ka_group_pack_step_probe(const int* in, long long* out, long long steps,
                             int ballot, cudaStream_t stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  if (ballot)
    ballot_probe_kernel<<<1, kWarp, 0, stream>>>(in, out, steps);
  else
    step_probe_kernel<<<1, kWarp, 0, stream>>>(in, out, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
