// Interior descent of the batched MCTS, fused into one launch per
// simulation, for Hopper (sm_90a).
//
// Replaces the lock-step interior levels of `_simulate_once` (the `body` of
// the while_loop at katacoffee_tpu/search/mcts.py:1267, and
// `_descend_interior_plain` in katacoffee_tpu_torch/search/mcts.py), and
// with them the per-level child-stats gather, the Pallas TPU kernel
// `_gather_kernel` of katacoffee_tpu/ops/gather.py:39.
//
// One warp walks one game from the node after the root level down to its
// leaf. Per level, lane l takes the candidate lanes c = l and c = l + 32 of
// the node's last-move line (C <= 63 lanes):
//   * the node's is_terminal, last_spot, last_dir, stats row and own utility;
//   * the candidate-table row cand[spot, dir, c] (int32, -1 padded);
//   * the compact children / edge_visits / prior entries at cand;
//   * each live child's 32-byte stats row as two float4 loads: the gather,
//     now into registers;
// then the edge stats (`_edge_stats_from_raw`) and the PUCT score
// (`_selection_compact`) of each lane, two warp sums and a warp argmax that
// keeps the lowest lane on ties, as torch.argmax does. Under graph search
// the chosen edge is caught up (`want_catch_at`, the JAX package's
// search/mcts.py:1209, used at :1333) when it has fewer visits than its
// child: has_child && (float)edge_visits < child S_VISITS - 0.5f. Lane 0
// records the chosen lane in acts[depth] (also where the child is missing or
// caught up: the expansion reads it), writes the level's lanes to the
// scratch slot depth-1 for the backup, counts the edge visit when it moves
// on, marks the game caught on a catch-up, and the warp steps to the child.
// It stops at a terminal node, a missing child, a catch-up or depth == D.
//
// Numerics: every operation is the plain torch version's, in its order, each
// rounded to float32 (built with --fmad=false, IEEE division and square
// root); a division by a Python scalar is torch's multiply by the float32
// reciprocal; the two sums follow torch's CUDA reduction of a [B, C] row
// (block width min(last_pow2(C), 32), one strided partial per lane, then
// shfl_down with decreasing offsets); fpuParentWeightByVisitedPolicyPow
// takes torch.pow's special cases for 0, 1, 2, 3, 0.5, -0.5, -1 and -2.
//
// Bound: latency, not bytes. A game-level moves about C*(12 + 32 + 44) + 80
// bytes (compact entries, child rows, the scratch slot, the node), 0.8 us of
// HBM time for a B=512 5x5 search, but each level is four dependent L2 round
// trips (node -> candidate row -> child slots -> child rows). Walking the
// whole descent inside the kernel is what removes the cost the lock-step
// loop paid per level: ~85 small launches and one host sync (`active.any()`)
// to decide whether to go on. No atomics: a warp is the only writer of its
// game's tree, and a path never repeats a node.
//
// Built by katacoffee_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kSlots = 2;  // candidate lanes per thread
constexpr unsigned kFull = 0xffffffffu;
#define KC_NEG_INF __int_as_float(0xff800000)

// fpu modes (0: the parent's utility): fpuParentWeightByVisitedPolicy,
// fpuParentWeight
constexpr int kFpuVisitedPolicy = 1, kFpuParentWeight = 2;
// torch.pow(tensor, scalar) special cases (0: powf)
constexpr int kPowZero = 1, kPowOne = 2, kPowTwo = 3, kPowThree = 4, kPowHalf = 5,
              kPowMinusHalf = 6, kPowMinusOne = 7, kPowMinusTwo = 8;

// SearchParams constants, each rounded to float32 as torch rounds a Python
// scalar against a float32 tensor (kc_descend_interior's argument order).
struct Select {
  float cpuct, cpuct_log, cpuct_base, inv_cpuct_base;
  float stdev_scale, stdev_prior, inv_stdev_prior, var_prior, stdev_prior_weight;
  float fpu_reduction_max, fpu_loss_prop, neg_wl_factor;
  float fpu_parent_weight, one_minus_fpu_parent_weight, visited_pow;
  float eps;
  int stdev_on, fpu_mode, pow_mode, graph;
};
constexpr int kNumFloats = 16;
constexpr int kNumInts = 4;
constexpr int kNumPointers = 21;  // kc_descend_interior's tensor arguments

struct Args {
  const long long* last_spot;     // [B, N]
  const long long* last_dir;      // [B, N]
  const unsigned char* terminal;  // [B, N] bool
  const int* cand;                // [area + 1, 5, C]
  const int* children;            // [B, N, A]
  int* edge_visits;               // [B, N, A], incremented along the path
  const float* prior;             // [B, N, A]
  const float4* stats;            // [B, N, 8] as [B, N, 2] float4
  const float* self_stats;        // [B, N, 4]
  const long long* node0;         // [B]
  const long long* depth0;        // [B]
  const unsigned char* active0;   // [B] bool
  long long* path;                // [B, D + 1]
  long long* acts;                // [B, D + 1]
  float4* cs_raw;                 // [B, D, C, 8] as [B, D, C, 2] float4
  float* prior_c;                 // [B, D, C]
  int* child_c;                   // [B, D, C]
  float* ev_c;                    // [B, D, C]
  long long* leaf;                // [B]
  long long* leaf_depth;          // [B]
  unsigned char* caught;          // [B] bool, stopped by a catch-up
  int b, n, a, c, d, area;
};

__device__ __forceinline__ float pow_scalar(float x, float e, int mode) {
  switch (mode) {
    case kPowZero: return 1.0f;
    case kPowOne: return x;
    case kPowTwo: return x * x;
    case kPowThree: return x * x * x;
    case kPowHalf: return sqrtf(x);
    case kPowMinusHalf: return rsqrtf(x);
    case kPowMinusOne: return 1.0f / x;
    case kPowMinusTwo: return 1.0f / (x * x);
    default: return powf(x, e);
  }
}

// Sum of the C lane values x[k] (lane c = lane + 32 k, 0 past C) in the
// order of torch's CUDA sum over the last dim of a contiguous [B, C] tensor;
// every lane gets the result.
__device__ __forceinline__ float torch_row_sum(const float (&x)[kSlots], int lane, int c,
                                               int width) {
  float v;
  if (width == 32) {
    v = x[0] + x[1];
  } else {  // c < 2 * width: lane l adds lane l + width
    const float up = __shfl_down_sync(kFull, x[0], width);
    v = x[0] + (lane + width < c ? up : 0.0f);
  }
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
descend_interior_kernel(Args g, Select s) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= g.b) return;  // whole warps leave together
  const int C = g.c;
  const int width = min(32, 1 << (31 - __clz(C)));  // last_pow2(C), capped
  const long long row0 = static_cast<long long>(b) * g.n;
  long long node = g.node0[b];
  long long depth = g.depth0[b];
  bool active = g.active0[b] != 0;
  bool caught = false;

  while (active) {
    const long long bn = row0 + node;
    const bool term = __ldg(g.terminal + bn) != 0;
    long long spot = __ldg(g.last_spot + bn);
    long long dir = __ldg(g.last_dir + bn);
    spot = (spot < 0 || spot > g.area) ? g.area : spot;
    dir = dir < 0 ? 0 : (dir > 4 ? 4 : dir);
    const int* cand_row = g.cand + (spot * 5 + dir) * C;
    const long long slot = (static_cast<long long>(b) * g.d + (depth - 1)) * C;

    int cand[kSlots], child[kSlots];
    float pr[kSlots], w[kSlots], lp_visited[kSlots], q_child[kSlots], ev[kSlots], cvis[kSlots];
    bool live[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      cand[k] = -1;
      child[k] = -1;
      pr[k] = -1.0f;
      w[k] = 0.0f;
      lp_visited[k] = 0.0f;
      q_child[k] = 0.0f;
      ev[k] = 0.0f;
      cvis[k] = 0.0f;
      live[k] = false;
      if (c >= C) continue;
      cand[k] = __ldg(cand_row + c);
      if (cand[k] >= 0) {
        const long long e = bn * g.a + cand[k];
        child[k] = __ldg(g.children + e);
        ev[k] = static_cast<float>(g.edge_visits[e]);
        pr[k] = __ldg(g.prior + e);
      }
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (child[k] >= 0 && child[k] < g.n) {
        const float4* r = g.stats + (row0 + child[k]) * 2;
        lo = __ldg(r);
        hi = __ldg(r + 1);
      }
      g.cs_raw[(slot + c) * 2] = lo;
      g.cs_raw[(slot + c) * 2 + 1] = hi;
      g.prior_c[slot + c] = pr[k];
      g.child_c[slot + c] = child[k];
      g.ev_c[slot + c] = ev[k];
      // _edge_stats_from_raw: lo = (visits, w, wsq, u)
      cvis[k] = lo.x;
      const float scale = ev[k] / fmaxf(lo.x, 1.0f);
      live[k] = child[k] >= 0 && ev[k] > 0.0f;
      w[k] = live[k] ? lo.y * scale : 0.0f;
      q_child[k] = -lo.w;
      lp_visited[k] = live[k] ? fmaxf(pr[k], 0.0f) : 0.0f;
    }
    if (term) break;  // the lanes are saved; nothing is recorded

    // _selection_compact
    const float4 ns = __ldg(g.stats + bn * 2);      // (visits, w, wsq, u)
    const float ns_usq = __ldg(g.stats + bn * 2 + 1).x;
    const float self_u = __ldg(g.self_stats + bn * 4);
    const float total_w = torch_row_sum(w, lane, C, width);
    const float mass = torch_row_sum(lp_visited, lane, C, width);

    float factor = 1.0f;
    if (s.stdev_on) {  // _stdev_factor
      const float w_sum = ns.y, u = ns.w;
      const float uu = u * u;
      const float usq = fmaxf(ns_usq, uu);
      const float num = (uu + s.var_prior) * s.stdev_prior_weight + usq * w_sum;
      const float den = s.stdev_prior_weight + fmaxf(w_sum - 1.0f, s.eps);
      float stdev = sqrtf(fmaxf(num / den - uu, 0.0f));
      stdev = w_sum <= 1.0f ? s.stdev_prior : stdev;
      factor = 1.0f + s.stdev_scale * (stdev * s.inv_stdev_prior - 1.0f);
    }
    // _explore_scaling
    const float cpuct =
        s.cpuct + s.cpuct_log * logf((total_w + s.cpuct_base) * s.inv_cpuct_base);
    const float explore = cpuct * sqrtf(total_w + 0.01f) * factor;
    // _fpu_parent_utility
    float parent_u = ns.w;
    if (s.fpu_mode == kFpuVisitedPolicy) {
      const float avg_w = fminf(pow_scalar(mass, s.visited_pow, s.pow_mode), 1.0f);
      parent_u = avg_w * ns.w + (1.0f - avg_w) * self_u;
    } else if (s.fpu_mode == kFpuParentWeight) {
      parent_u = s.fpu_parent_weight * self_u + s.one_minus_fpu_parent_weight * ns.w;
    }
    float fpu = parent_u - s.fpu_reduction_max * sqrtf(mass);
    fpu = fpu + (s.neg_wl_factor - fpu) * s.fpu_loss_prop;

    float best_v = KC_NEG_INF;
    int best_c = INT_MAX;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = lane + 32 * k;
      if (c >= C) continue;
      const float q = live[k] ? q_child[k] : fpu;
      float v = explore * fmaxf(pr[k], 0.0f) / (1.0f + w[k]) + q;
      v = pr[k] < 0.0f ? KC_NEG_INF : v;
      if (best_c == INT_MAX || v > best_v) {
        best_v = v;
        best_c = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best_v, off);
      const int oc = __shfl_xor_sync(kFull, best_c, off);
      if (ov > best_v || (ov == best_v && oc < best_c)) {
        best_v = ov;
        best_c = oc;
      }
    }
    const bool hi = (best_c >> 5) != 0;  // the same in every lane
    const int src = best_c & 31;
    const int sel_child = __shfl_sync(kFull, hi ? child[1] : child[0], src);
    const int sel_cand = __shfl_sync(kFull, hi ? cand[1] : cand[0], src);
    const float sel_ev = __shfl_sync(kFull, hi ? ev[1] : ev[0], src);
    const float sel_cvis = __shfl_sync(kFull, hi ? cvis[1] : cvis[0], src);

    // graph search's edge-visit catch-up (_want_catch)
    const bool catch_up = s.graph && sel_child >= 0 && sel_ev < sel_cvis - 0.5f;
    const long long prow = static_cast<long long>(b) * (g.d + 1);
    const bool move_on = sel_child >= 0 && !catch_up;
    if (lane == 0) {
      g.acts[prow + depth] = best_c;
      if (move_on) {
        g.edge_visits[bn * g.a + sel_cand] += 1;
        g.path[prow + depth + 1] = sel_child;
      }
    }
    caught = catch_up;
    if (!move_on) break;
    node = sel_child;
    depth += 1;
    active = depth < g.d;
  }
  if (lane == 0) {
    g.leaf[b] = node;
    g.leaf_depth[b] = depth;
    g.caught[b] = caught ? 1 : 0;
  }
}

}  // namespace

// The argument layout the wrapper must pass: kNumFloats * 10000 +
// kNumInts * 100 + kNumPointers.
extern "C" int kc_descend_layout() { return kNumFloats * 10000 + kNumInts * 100 + kNumPointers; }

// Launches the descent on `stream`; returns the cudaError_t of the launch.
// `f` holds the kNumFloats Select floats and `i` the kNumInts ints, in
// struct order.
extern "C" int kc_descend_interior(
    const void* last_spot, const void* last_dir, const void* terminal, const void* cand,
    const void* children, void* edge_visits, const void* prior, const void* stats,
    const void* self_stats, const void* node0, const void* depth0, const void* active0,
    void* path, void* acts, void* cs_raw, void* prior_c, void* child_c, void* ev_c,
    void* leaf, void* leaf_depth, void* caught, int b, int n, int a, int c, int d, int area,
    const float* f, const int* i, void* stream) {
  if (b == 0) return 0;
  if (c < 1 || c >= 32 * kSlots || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args g{static_cast<const long long*>(last_spot), static_cast<const long long*>(last_dir),
         static_cast<const unsigned char*>(terminal), static_cast<const int*>(cand),
         static_cast<const int*>(children), static_cast<int*>(edge_visits),
         static_cast<const float*>(prior), static_cast<const float4*>(stats),
         static_cast<const float*>(self_stats), static_cast<const long long*>(node0),
         static_cast<const long long*>(depth0), static_cast<const unsigned char*>(active0),
         static_cast<long long*>(path), static_cast<long long*>(acts),
         static_cast<float4*>(cs_raw), static_cast<float*>(prior_c),
         static_cast<int*>(child_c), static_cast<float*>(ev_c),
         static_cast<long long*>(leaf), static_cast<long long*>(leaf_depth),
         static_cast<unsigned char*>(caught), b, n, a, c, d, area};
  Select s{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
           f[11], f[12], f[13], f[14], f[15], i[0], i[1], i[2], i[3]};
  static_assert(sizeof(Select) == (kNumFloats + kNumInts) * 4, "Select layout");
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  descend_interior_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      g, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kc_descend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
