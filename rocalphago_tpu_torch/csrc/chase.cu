// Per-lane ladder read: is the prey group ladder-captured with the
// chaser to move?
//
// Replaces the TPU kernel rocalphago_tpu/ops/chase.py::pallas_chase
// (body _chase_kernel) and computes what it computes, lane by lane:
// each rung is two plies -- the chaser fills one of the prey's two
// liberties, the prey answers with its forced response (extend at its
// last liberty, or counter-capture an adjacent chaser group in atari)
// -- and the chaser picks the option with the best outcome for it.
// Tie-breaks are the reference's: first liberty by flat index, option
// pick o1 <= o2, response pick L1 >= L2. A lane whose prey index is
// negative is disabled and reads False. The read core (the prey's
// stones, the prey point and every cell a rung changed) is collected
// per rung, as the TPU kernel's collect_core does.
//
// What bounds it on an H100: latency. A lane reads one board (N bytes
// plus N int32 labels) and writes one byte (plus N for the core), and
// a rung is a few hundred integer ops per point; but a rung is a chain
// of some 20 dependent block-wide decisions (liberty counts, first
// liberty, option outcomes, the counter-capture target), and a ladder
// runs up to `depth` rungs. The design keeps each lane's board, labels
// and per-root liberty table in shared memory for the whole read (one
// block per lane, one thread per point, nothing goes back to device
// memory between rungs), gives each lane its own loop (a settled lane
// exits at once instead of waiting for the slowest, which is what the
// reference's lockstep XLA loop pays), and makes every scalar decision
// with a barrier-fused reduction (__syncthreads_count/_or, warp
// __reduce_min_sync). Liberty counts come from shared-memory atomics
// over each empty point's distinct neighbour roots, in place of the
// TPU kernel's (N, N) root x point tables, which were only its way
// round having no scatter.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CAPTURED = 0, CONTINUE = 1, ESCAPED = 2;
constexpr int NONE = INT_MAX;  // "no point" from a min over an empty set

struct Lane {
  int size, n;
  bool live;  // this thread owns a board point
  int p;      // that point
  int8_t* board;
  int32_t* lab;
  int32_t* libs;     // [n + 1] distinct liberties per root; libs[n] = 0
  uint8_t* gained;   // [n + 1] roots that gained a liberty from a capture
  int8_t* b1;        // board after the chaser's move
  uint8_t* prey;     // prey group mask (rung start)
  uint8_t* gc;       // chaser group merged around the chaser's move
  uint8_t* scratch;  // cap0, then the counter-capture target mask
  uint8_t* comp;     // try_move: prey component after the response
  uint8_t* cluster;  // try_move: the response stone's cluster
  int* red;          // [32] per-warp partial minima
};

__device__ __forceinline__ int nbr(int p, int d, int size, int n) {
  switch (d) {
    case 0: return p + size < n ? p + size : -1;
    case 1: return p >= size ? p - size : -1;
    case 2: return p % size < size - 1 ? p + 1 : -1;
    default: return p % size > 0 ? p - 1 : -1;
  }
}

__device__ __forceinline__ bool dil(const uint8_t* m, int p, int size,
                                    int n) {
  if (m[p]) return true;
  for (int d = 0; d < 4; ++d) {
    const int q = nbr(p, d, size, n);
    if (q >= 0 && m[q]) return true;
  }
  return false;
}

__device__ __forceinline__ bool in_roots(int v, const int* r, int k) {
  for (int j = 0; j < k; ++j)
    if (r[j] == v) return true;
  return false;
}

// Minimum of v over the block (a barrier for every thread).
__device__ int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = NONE;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
    r = min(r, red[i]);
  __syncthreads();
  return r;
}

// Chaser-move legality and captures at pt (pre-move analysis): mirror
// of ladders._place. Writes b1; returns ok, sets this thread's cap0.
__device__ bool place(const Lane& s, int pt, int color, bool* cap0) {
  bool has_empty = false, own_safe = false;
  int cr[4], k = 0;
  for (int d = 0; d < 4; ++d) {
    const int q = nbr(pt, d, s.size, s.n);
    if (q < 0) continue;
    const int qc = s.board[q], qr = s.lab[q], ql = s.libs[qr];
    if (qc == -color && ql == 1) cr[k++] = qr;
    has_empty |= qc == 0;
    own_safe |= qc == color && ql >= 2;
  }
  const bool ok = s.board[pt] == 0 && (has_empty || own_safe || k > 0);
  *cap0 = ok && s.live && in_roots(s.lab[s.p], cr, k);
  __syncthreads();  // earlier readers of b1 are done
  if (s.live)
    s.b1[s.p] = *cap0 ? 0 : (s.p == pt ? color : s.board[s.p]);
  __syncthreads();
  return ok;
}

struct Response {
  int preyL1, respL, resp_pt;
};

// One candidate response of the prey at pt: mirror of try_move in
// ladders._escaper_response_full. Returns the prey's liberties after
// it, or -1 if it is not a legal move; sets this thread's esc_cap.
__device__ int try_move(const Lane& s, int pt, bool enabled, int chaser,
                        int prey_color, int gc_nlibs, bool gc_p,
                        bool empty1_p, bool pm, bool* esc_cap) {
  *esc_cap = false;
  if (!enabled || pt == NONE) return -1;  // uniform across the block
  int er[4], ne = 0, mr[4], nm = 0;
  bool gc_adj = false;
  for (int d = 0; d < 4; ++d) {
    const int q = nbr(pt, d, s.size, s.n);
    if (q < 0) continue;
    const int qc = s.b1[q], qr = s.lab[q];
    const bool in_gc = s.gc[q];
    const bool qgained = qr < s.n && s.gained[qr];
    if (qc == chaser && !in_gc && s.libs[qr] == 1 && !qgained) er[ne++] = qr;
    gc_adj |= qc == chaser && in_gc;
    if (qc == prey_color) mr[nm++] = qr;
  }
  bool esc = false, clus = false, empty2 = false;
  const bool join = dil(s.prey, pt, s.size, s.n);
  if (s.live) {
    const int l = s.lab[s.p];
    esc = in_roots(l, er, ne) || (gc_adj && gc_nlibs == 1 && gc_p);
    clus = s.p == pt || in_roots(l, mr, nm);
    empty2 = (empty1_p && s.p != pt) || esc;
    s.comp[s.p] = join ? (pm || clus) : pm;
    s.cluster[s.p] = clus;
  }
  __syncthreads();
  const int libs2 = __syncthreads_count(
      s.live && empty2 && dil(s.comp, s.p, s.size, s.n));
  const bool legal = __syncthreads_or(
      s.live && empty2 && dil(s.cluster, s.p, s.size, s.n));
  const bool okm = s.b1[pt] == 0 && legal;
  *esc_cap = esc && okm;
  return okm ? libs2 : -1;
}

// The prey's forced response after the chaser played c_pt: mirror of
// ladders._escaper_response_full on the rung's pre-move analysis.
// Returns early (respL unset) when the prey is not left in atari.
__device__ Response escaper_response(const Lane& s, int c_pt, int chaser,
                                     int prey_color, bool pm, bool cap0,
                                     bool* resp_cap) {
  Response out{0, -1, NONE};
  *resp_cap = false;
  const bool empty1_p = s.live && s.b1[s.p] == 0;
  const bool dil_prey_p = s.live && dil(s.prey, s.p, s.size, s.n);
  const bool prey_lib_p = empty1_p && dil_prey_p;
  out.preyL1 = __syncthreads_count(prey_lib_p);
  if (out.preyL1 != 1) return out;  // the option is scored ESCAPED
  const int ext_pt = block_min(prey_lib_p ? s.p : NONE, s.red);

  // the chaser group merged around c_pt
  int gr[4], ng = 0;
  for (int d = 0; d < 4; ++d) {
    const int q = nbr(c_pt, d, s.size, s.n);
    if (q >= 0 && s.b1[q] == chaser) gr[ng++] = s.lab[q];
  }
  const bool gc_p = s.live && (s.p == c_pt || in_roots(s.lab[s.p], gr, ng));
  if (s.live) {
    s.gc[s.p] = gc_p;
    s.scratch[s.p] = cap0;
  }
  for (int i = threadIdx.x; i <= s.n; i += blockDim.x) s.gained[i] = 0;
  __syncthreads();
  const int gc_nlibs = __syncthreads_count(
      empty1_p && dil(s.gc, s.p, s.size, s.n));

  // chaser groups that gained a liberty from the chaser's capture
  if (s.live && s.b1[s.p] == chaser && s.lab[s.p] < s.n &&
      dil(s.scratch, s.p, s.size, s.n))
    s.gained[s.lab[s.p]] = 1;
  __syncthreads();
  const int l = s.live ? s.lab[s.p] : s.n;
  const bool gained_p = l < s.n && s.gained[l];

  // counter-capture target: first chaser stone next to the prey whose
  // group is in atari on b1
  const bool atari_p =
      s.live && s.b1[s.p] == chaser && dil_prey_p &&
      (gc_p ? gc_nlibs == 1 : (s.libs[l] == 1 && !gained_p));
  const int target = block_min(atari_p ? s.p : NONE, s.red);
  const bool have_cap = target != NONE;
  int cap_pt = NONE;
  if (have_cap) {
    const bool t_in_gc = s.gc[target];
    const int t_root = s.lab[target];
    if (s.live) s.scratch[s.p] = t_in_gc ? gc_p : l == t_root;
    __syncthreads();
    cap_pt = block_min(
        empty1_p && dil(s.scratch, s.p, s.size, s.n) ? s.p : NONE, s.red);
  }

  bool c1, c2;
  const int l1 = try_move(s, ext_pt, true, chaser, prey_color, gc_nlibs,
                          gc_p, empty1_p, pm, &c1);
  const int l2 = try_move(s, cap_pt, have_cap, chaser, prey_color,
                          gc_nlibs, gc_p, empty1_p, pm, &c2);
  const bool take1 = l1 >= l2;
  out.respL = take1 ? l1 : l2;
  out.resp_pt = take1 ? ext_pt : cap_pt;
  *resp_cap = take1 ? c1 : c2;
  return out;
}

// Chaser fills lib_pt: the option's outcome for the chaser.
__device__ int option(const Lane& s, int lib_pt, int chaser, int prey_color,
                      bool pm, bool* cap0, bool* resp_cap, int* resp_pt) {
  const bool ok = place(s, lib_pt, chaser, cap0);
  *resp_cap = false;
  *resp_pt = NONE;
  if (!ok) return ESCAPED;
  const Response r =
      escaper_response(s, lib_pt, chaser, prey_color, pm, *cap0, resp_cap);
  if (r.preyL1 != 1) return ESCAPED;
  *resp_pt = r.resp_pt;
  return r.respL <= 1 ? CAPTURED : (r.respL >= 3 ? ESCAPED : CONTINUE);
}

// Place color at pt and remove cap: mirror of ladders._relabel_place
// (a placement only merges groups, a capture removes whole groups, so
// the min-root labels stay exact without a fill).
__device__ void relabel(const Lane& s, int pt, int color, bool cap) {
  int mr[4], k = 0, new_root = pt;
  for (int d = 0; d < 4; ++d) {
    const int q = nbr(pt, d, s.size, s.n);
    if (q >= 0 && s.board[q] == color) {
      mr[k++] = s.lab[q];
      new_root = min(new_root, s.lab[q]);
    }
  }
  int nl = 0;
  int8_t nb = 0;
  if (s.live) {
    const int l = s.lab[s.p];
    nl = cap ? s.n : ((s.p == pt || in_roots(l, mr, k)) ? new_root : l);
    nb = cap ? 0 : (s.p == pt ? color : s.board[s.p]);
  }
  __syncthreads();
  if (s.live) {
    s.lab[s.p] = nl;
    s.board[s.p] = static_cast<int8_t>(nb);
  }
  __syncthreads();
}

__global__ void chase_kernel(const int8_t* __restrict__ boards,
                             const int32_t* __restrict__ labels,
                             const int32_t* __restrict__ prey_pts,
                             uint8_t* __restrict__ captured_out,
                             uint8_t* __restrict__ core_out, int size,
                             int depth) {
  extern __shared__ int32_t smem[];
  Lane s;
  s.size = size;
  s.n = size * size;
  const int n = s.n;
  s.p = threadIdx.x;
  s.live = s.p < n;
  s.lab = smem;
  s.libs = s.lab + n;
  s.red = s.libs + n + 1;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(s.red + 32);
  s.gained = bytes;
  s.board = reinterpret_cast<int8_t*>(s.gained + n + 1);
  s.b1 = s.board + n;
  s.prey = reinterpret_cast<uint8_t*>(s.b1 + n);
  s.gc = s.prey + n;
  s.scratch = s.gc + n;
  s.comp = s.scratch + n;
  s.cluster = s.comp + n;

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  if (s.live) {
    s.board[s.p] = boards[base + s.p];
    s.lab[s.p] = labels[base + s.p];
  }
  const int P = prey_pts[blockIdx.x];
  const bool enabled = P >= 0 && P < n;
  __syncthreads();
  const int prey_color = enabled ? s.board[P] : 0;
  const int chaser = -prey_color;

  bool core = false, captured = false, done = !enabled;
  for (int rung = 0; rung < depth && !done; ++rung) {
    // distinct-liberty count per root
    for (int i = threadIdx.x; i <= n; i += blockDim.x) s.libs[i] = 0;
    __syncthreads();
    if (s.live && s.board[s.p] == 0) {
      int seen[4], k = 0;
      for (int d = 0; d < 4; ++d) {
        const int q = nbr(s.p, d, size, n);
        if (q < 0) continue;
        const int r = s.lab[q];
        if (r < n && !in_roots(r, seen, k)) {
          seen[k++] = r;
          atomicAdd(&s.libs[r], 1);
        }
      }
    }
    __syncthreads();

    const int prey_root = s.lab[P];
    const bool prey_alive = s.board[P] == prey_color;
    const int L = prey_alive ? s.libs[prey_root] : 0;
    const bool pm = s.live && s.lab[s.p] == prey_root;
    const bool stone_p = s.live && s.board[s.p] != 0;
    const int8_t board_before = s.live ? s.board[s.p] : 0;

    int o = !prey_alive ? CAPTURED
                        : (L >= 3 ? ESCAPED : (L == 1 ? CAPTURED : -1));
    if (o < 0 && L != 2) o = ESCAPED;  // both options disabled
    if (o < 0) {
      if (s.live) s.prey[s.p] = pm;
      __syncthreads();
      const bool lib_p = s.live && s.board[s.p] == 0 &&
                         dil(s.prey, s.p, size, n);
      const int l1 = block_min(lib_p ? s.p : NONE, s.red);
      const int l2 = block_min(lib_p && s.p != l1 ? s.p : NONE, s.red);
      bool cap0_1, rcap_1, cap0_2, rcap_2;
      int rpt_1, rpt_2;
      const int o1 = option(s, l1, chaser, prey_color, pm, &cap0_1, &rcap_1,
                            &rpt_1);
      const int o2 = option(s, l2, chaser, prey_color, pm, &cap0_2, &rcap_2,
                            &rpt_2);
      const bool pick1 = o1 <= o2;
      o = pick1 ? o1 : o2;
      if (o == CONTINUE) {
        relabel(s, pick1 ? l1 : l2, chaser, pick1 ? cap0_1 : cap0_2);
        relabel(s, pick1 ? rpt_1 : rpt_2, prey_color,
                pick1 ? rcap_1 : rcap_2);
      }
    }
    core |= (pm && stone_p) || s.p == P ||
            (s.live && s.board[s.p] != board_before);
    captured = o == CAPTURED;
    done = o != CONTINUE;
    __syncthreads();
  }
  if (core_out != nullptr && s.live)
    core_out[base + s.p] = enabled && core;
  if (threadIdx.x == 0) captured_out[blockIdx.x] = enabled && captured;
}

}  // namespace

// boards int8 [lanes, n]; labels int32 [lanes, n] (carried min-root
// labels); prey int32 [lanes] (flat prey point, negative = disabled);
// captured uint8 [lanes]; core uint8 [lanes, n] or null.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rocalphago_chase(const void* boards, const void* labels,
                                const void* prey, void* captured, void* core,
                                int lanes, int size, int depth,
                                void* stream) {
  const int n = size * size;
  const int threads = (n + 31) / 32 * 32;
  if (lanes <= 0 || size <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = (2 * n + 1 + 32) * sizeof(int32_t) + (n + 1) +
                       7 * static_cast<size_t>(n);
  chase_kernel<<<lanes, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(prey), static_cast<uint8_t*>(captured),
      static_cast<uint8_t*>(core), size, depth);
  return static_cast<int>(cudaGetLastError());
}
