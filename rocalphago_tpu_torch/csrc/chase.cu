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
// plus N int32 labels) and writes one byte (plus N for the core); a
// rung is a few hundred integer ops per point, but it is one chain of
// dependent lane-wide decisions (the prey's liberties, the option's
// legality and captures, the prey's forced response, the
// counter-capture target, the pick), and a ladder runs up to `depth`
// rungs. What a rung costs is the length of that chain in instructions
// and warp collectives, each waiting on the one before.
//
// - One warp per lane, kLanesPerBlock = 4 lanes per block, nothing
//   shared between them: a settled or disabled lane's warp exits at
//   once, and the kernel has no block barrier anywhere. Four lanes per
//   block put one lane on each of an SM's four schedulers, so a short
//   batch (6 lanes a genmove) spreads over schedulers; 1,536 lanes
//   (batch 256 x 6 slots) are 384 blocks, about 12 warps per SM, all
//   resident in one wave.
// - Thread r owns row r of the board: points r*size .. r*size+size-1,
//   the flat order the reference's neighbour tables use (p + size is
//   the next row). So size <= 32. Every mask -- the board's two
//   colours, the prey group, the chaser group merged around the move,
//   the capture masks, the response's cluster, the empty points -- is
//   one uint32 row per thread in registers. Dilation is two shifts and
//   __shfl_up/down_sync, a count is __reduce_add_sync of __popc, "first
//   point by flat index" is a ballot, __ffs and __shfl_sync, a test of
//   a point and its neighbours is three __shfl_sync of the rows around
//   it. Each replaces a block-wide reduction of the first design (two
//   block barriers and a serial pass over 12 warps' partial results):
//   a warp collective is a few tens of cycles where a block barrier
//   chain was hundreds. Row and column come from the thread and the
//   bit, never from a division (one per lane, for the prey point).
// - Group identity is the carried min-root labels, one warp's int32
//   rows in shared memory (each row padded to a multiple of 4 so that a
//   thread reads or writes its row with 128-bit accesses), so the
//   exactness argument of ladders._relabel_place holds as it is: a
//   placement only merges groups (the min of the merged roots and the
//   point), a capture removes whole groups (reset to n). A group's row
//   mask is one compare per point of the thread's row.
// - Liberties come from a per-root table in shared memory, the
//   reference's lib_counts_from_labels: built at a lane's first rung
//   (each thread adds its row's empty points to their distinct
//   neighbouring roots with shared atomics), then kept exact by each
//   placement (the other colour's neighbouring roots lose one liberty,
//   the merged root takes the count the rung already has), and rebuilt
//   only after a capture. A rung that continues hands the next one the
//   prey group and its two liberties from the chosen response.
// - The rung is inlined, with one copy of each part (the two options,
//   the two responses, the two placements run in loops that are not
//   unrolled), and per-thread work is branch-free (selects, atomics
//   that add to a discard slot), because a divergent branch costs a
//   reconvergence barrier and every instruction of a longer program
//   costs fetch time when a launch first reaches it.
//
// Tensor cores and TMA do not apply: this is integer bit work on a
// board that fits in a warp's registers, and the input is read once.

#include <cstdint>
#include <cuda_runtime.h>

// Per warp: the labels, one row of kStride<S> int32 per board row (the
// row padded to a multiple of 4 so that a thread reads and writes its
// row with 128-bit accesses), int32 libs[n + 1] and a discard slot per
// thread, and uint8 gained[n + 1].
extern __shared__ int4 chase_smem[];

namespace {

constexpr int CAPTURED = 0, CONTINUE = 1, ESCAPED = 2;
constexpr int kLanesPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Row stride of the labels, and the length of a row held in registers.
template <int S>
constexpr int kStride = S > 0 ? (S + 3) / 4 * 4 : 32;

__device__ __forceinline__ int32_t* words() {
  return reinterpret_cast<int32_t*>(chase_smem);
}

struct Pt {
  int r, c;  // row and column; r < 0: no point
};

__device__ __forceinline__ Pt no_point() { return Pt{-1, 0}; }

__device__ __forceinline__ int count(uint32_t m) {
  return static_cast<int>(__reduce_add_sync(kFull, __popc(m)));
}

// Is p in mask m? (uniform p; false for no point)
__device__ __forceinline__ bool bit(uint32_t m, Pt p) {
  return p.r >= 0 && ((__shfl_sync(kFull, m, p.r) >> p.c) & 1u);
}

// The first point of m by flat index, or no point.
__device__ __forceinline__ Pt first(uint32_t m) {
  const uint32_t rows = __ballot_sync(kFull, m != 0);
  if (rows == 0) return no_point();
  const int r = __ffs(rows) - 1;
  return Pt{r, __ffs(__shfl_sync(kFull, m, r)) - 1};
}

// The first two points of m by flat index (no point where m has fewer):
// one ballot and two shuffles side by side.
__device__ __forceinline__ void first2(uint32_t m, Pt* p1, Pt* p2) {
  const uint32_t rows = __ballot_sync(kFull, m != 0);
  const uint32_t rows2 = rows & (rows - 1);
  const int r1 = rows != 0 ? __ffs(rows) - 1 : 0;
  const int r2 = rows2 != 0 ? __ffs(rows2) - 1 : 0;
  const uint32_t row1 = __shfl_sync(kFull, m, r1);
  const uint32_t row2 = __shfl_sync(kFull, m, r2);
  const uint32_t rest = row1 & (row1 - 1);
  *p1 = rows != 0 ? Pt{r1, __ffs(row1) - 1} : no_point();
  *p2 = rest != 0 ? Pt{r1, __ffs(rest) - 1}
                  : (rows2 != 0 ? Pt{r2, __ffs(row2) - 1} : no_point());
}

// Which of p's neighbours (bit d for neighbour d, in the order of
// Lane::nbr; `on` has bit d set where neighbour d is on the board) are
// in m, and is p itself (bit 4): the rows p.r - 1, p.r and p.r + 1 by
// three shuffles.
__device__ __forceinline__ uint32_t nbits(uint32_t m, Pt p, uint32_t on) {
  const uint32_t up = __shfl_sync(kFull, m, p.r > 0 ? p.r - 1 : 0);
  const uint32_t mid = __shfl_sync(kFull, m, p.r);
  const uint32_t dn = __shfl_sync(kFull, m, p.r < 31 ? p.r + 1 : 31);
  const uint32_t c = p.c;
  const uint32_t b = ((dn >> c) & 1u) | ((up >> c) & 1u) << 1 |
                     (c < 31 ? (mid >> (c + 1)) & 1u : 0u) << 2 |
                     (c > 0 ? (mid >> (c - 1)) & 1u : 0u) << 3;
  return (b & on) | ((mid >> c) & 1u) << 4;
}

// One warp's view of its lane. S is the board size when it is known at
// compile time, 0 for any size <= 32. Thread `row` holds row `row` of
// every mask (bit c = point row*size + c); rows past the board hold 0.
template <int S>
struct Lane {
  static constexpr int W = kStride<S>;
  int size_arg, row;
  uint32_t rowmask;  // this thread's points; 0 past the board
  int lab_at, libs_at, gained_at;  // offsets of the lane's arrays

  __device__ __forceinline__ int size() const {
    return S > 0 ? S : size_arg;
  }
  __device__ __forceinline__ int n() const { return size() * size(); }
  __device__ __forceinline__ bool live() const { return row < size(); }
  __device__ __forceinline__ int flat(Pt p) const {
    return p.r * size() + p.c;
  }
  __device__ __forceinline__ uint32_t one(Pt p) const {
    return p.r == row ? 1u << p.c : 0u;
  }
  // carried min-root label of point p (a flat index; n when empty)
  __device__ __forceinline__ int32_t& lab(Pt p) const {
    return words()[lab_at + p.r * W + p.c];
  }
  // the label of q, or -1 when q is no point (a load either way, so
  // that the loads of a point's neighbours go out together)
  __device__ __forceinline__ int lab_or_none(Pt q) const {
    const int v = words()[lab_at + (q.r >= 0 ? q.r * W + q.c : 0)];
    return q.r >= 0 ? v : -1;
  }
  // the rung's distinct-liberty count of root r (0 for r = n); slots
  // n + 1 + row take this thread's discarded counts
  __device__ __forceinline__ int32_t& libs(int r) const {
    return words()[libs_at + r];
  }
  // root r's group gained a liberty from the chaser move's captures
  __device__ __forceinline__ uint8_t& gained(int r) const {
    return reinterpret_cast<uint8_t*>(chase_smem)[gained_at + r];
  }
  // this thread's row of labels (row 0 past the board, whose masks the
  // caller clears with rowmask)
  __device__ __forceinline__ const int4* row4() const {
    return &chase_smem[(lab_at + (live() ? row : 0) * W) / 4];
  }
  // neighbour d of p (a point): next row, previous row, next column,
  // previous column (the order of the reference's neighbour tables)
  __device__ __forceinline__ Pt nbr(Pt p, int d) const {
    switch (d) {
      case 0: return p.r + 1 < size() ? Pt{p.r + 1, p.c} : no_point();
      case 1: return p.r > 0 ? Pt{p.r - 1, p.c} : no_point();
      case 2: return p.c + 1 < size() ? Pt{p.r, p.c + 1} : no_point();
      default: return p.c > 0 ? Pt{p.r, p.c - 1} : no_point();
    }
  }
  // bit d: neighbour d of p is on the board
  __device__ __forceinline__ uint32_t on(Pt p) const {
    return static_cast<uint32_t>(p.r + 1 < size()) |
           static_cast<uint32_t>(p.r > 0) << 1 |
           static_cast<uint32_t>(p.c + 1 < size()) << 2 |
           static_cast<uint32_t>(p.c > 0) << 3;
  }
  // the 4-neighbourhood of m, without m itself
  __device__ __forceinline__ uint32_t around(uint32_t m) const {
    uint32_t up = __shfl_up_sync(kFull, m, 1);
    uint32_t dn = __shfl_down_sync(kFull, m, 1);
    if (row == 0) up = 0;
    if (row == 31) dn = 0;
    return (m << 1 | m >> 1 | up | dn) & rowmask;
  }
  // m and its 4-neighbourhood
  __device__ __forceinline__ uint32_t dil(uint32_t m) const {
    return m | around(m);
  }
};

// Mask bits of one row chunk of four labels equal to v.
__device__ __forceinline__ uint32_t eq4(int4 x, int v) {
  return static_cast<uint32_t>(x.x == v) |
         static_cast<uint32_t>(x.y == v) << 1 |
         static_cast<uint32_t>(x.z == v) << 2 |
         static_cast<uint32_t>(x.w == v) << 3;
}

// The points labelled v: the thread's row in 128-bit loads.
template <int S>
__device__ __forceinline__ uint32_t group(const Lane<S>& s, int v) {
  const int4* src = s.row4();
  uint32_t g = 0;
#pragma unroll
  for (int i = 0; i < Lane<S>::W / 4; ++i) g |= eq4(src[i], v) << (4 * i);
  return g & s.rowmask;
}

struct Masks {
  uint32_t m[4];
};

// The points labelled v[d] for each d (-1: none): no pass when none is
// wanted, one pass for all that are.
template <int S>
__device__ __forceinline__ Masks wanted(const Lane<S>& s,
                                        const int (&v)[4]) {
  Masks g{{0, 0, 0, 0}};
  const int k = (v[0] >= 0) + (v[1] >= 0) + (v[2] >= 0) + (v[3] >= 0);
  if (k == 0) return g;
  if (k == 1) {
    const int r = max(max(v[0], v[1]), max(v[2], v[3]));
    const uint32_t m = group(s, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) g.m[i] = v[i] >= 0 ? m : 0u;
    return g;
  }
  const int4* src = s.row4();
#pragma unroll
  for (int i = 0; i < Lane<S>::W / 4; ++i) {
    const int4 x = src[i];
#pragma unroll
    for (int d = 0; d < 4; ++d) g.m[d] |= eq4(x, v[d]) << (4 * i);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) g.m[d] &= s.rowmask;
  return g;
}

// One empty point's count into the liberty table: one to each distinct
// neighbouring root below n; a root not counted (or a point that is
// not valid) goes to the thread's discard slot, so the atomics are
// unconditional.
template <int S>
__device__ __forceinline__ void count_point(const Lane<S>& s,
                                            const int32_t* lr, int c,
                                            bool valid, int up, int dn) {
  const int n = s.n(), size = s.size(), discard = n + 1 + s.row;
  const int32_t* p = lr + c;
  const int a0 = p[c + 1 < size ? 1 : 0], b0 = p[c > 0 ? -1 : 0];
  const int u0 = p[up], d0 = p[dn];
  const int a = valid && c + 1 < size ? a0 : n;
  const int b = valid && c > 0 ? b0 : n;
  const int u = valid && up != 0 ? u0 : n;
  const int d = valid && dn != 0 ? d0 : n;
  const bool ka = a < n, kb = b < n && b != a,
             ku = u < n && u != a && u != b,
             kd = d < n && d != a && d != b && d != u;
  atomicAdd(&s.libs(ka ? a : discard), 1);
  atomicAdd(&s.libs(kb ? b : discard), 1);
  atomicAdd(&s.libs(ku ? u : discard), 1);
  atomicAdd(&s.libs(kd ? d : discard), 1);
}

// The rung's distinct-liberty count per root, from the empty points
// next to a stone (the reference's lib_counts_from_labels: each empty
// point adds one to each distinct neighbouring root below n). Each
// thread walks its row's points two at a time.
template <int S>
__device__ __forceinline__ void liberty_table(const Lane<S>& s,
                                              uint32_t empty) {
  constexpr int W = Lane<S>::W;
  const int n = s.n(), size = s.size();
  for (int i = s.row; i <= n; i += 32) s.libs(i) = 0;
  __syncwarp();
  const int32_t* lr = &words()[s.lab_at + (s.live() ? s.row * W : 0)];
  const int up = s.row > 0 ? -W : 0, dn = s.row + 1 < size ? W : 0;
  for (uint32_t e = empty; e != 0;) {
    const int c1 = __ffs(e) - 1;
    e &= e - 1;
    const bool two = e != 0;
    const int c2 = two ? __ffs(e) - 1 : c1;
    e &= two ? e - 1 : 0u;
    count_point(s, lr, c1, true, up, dn);
    count_point(s, lr, c2, two, up, dn);
  }
  __syncwarp();
}

// Set (v = 1) or clear (v = 0) the gained flag of the root of every
// point of m.
template <int S>
__device__ __forceinline__ void mark_gained(const Lane<S>& s, uint32_t m,
                                            uint8_t v) {
  for (; m != 0; m &= m - 1) s.gained(s.lab(Pt{s.row, __ffs(m) - 1})) = v;
  __syncwarp();
}

// The rung's board after one chaser option, with what the prey's
// response reads: the inputs of ladders._escaper_response_full.
struct Ply {
  uint32_t E1, C1;     // prey-colour and chaser stones after the move
  uint32_t empty1;     // empty points after it
  uint32_t pm;         // the prey group (rung start)
  uint32_t dil_prey;   // the prey group and its neighbours
  uint32_t gc;         // the chaser group merged around the move
  int gc_nlibs;        // its liberties after the move
  int prey_root;
  bool captures;       // the move captured (gained flags are set)
};

// Counter-capture target: the first chaser stone (flat order) next to
// the prey whose group is in atari after the move -- the merged group
// at one liberty, any other at one liberty before the move that gained
// none from the move's captures. Each thread tests its row's
// candidates and a ballot picks the first row.
template <int S>
__device__ __forceinline__ Pt atari_target(const Lane<S>& s,
                                           const Ply& y) {
  const uint32_t cand = y.C1 & y.dil_prey;
  uint32_t hit = y.gc_nlibs == 1 ? cand & y.gc : 0u;
  for (uint32_t x = cand & ~y.gc; x != 0; x &= x - 1) {
    const int c = __ffs(x) - 1;
    const int r = s.lab(Pt{s.row, c});
    const bool gained = y.captures && s.gained(r);
    hit |= static_cast<uint32_t>(s.libs(r) == 1 && !gained) << c;
  }
  return first(hit);
}

struct Resp {
  int libs;          // the prey's liberties after it, -1: illegal
  uint32_t cap;      // chaser stones it captures
  uint32_t prey;     // the prey group after it
  uint32_t prey_libs;  // and its liberties
  int own_libs;      // liberties of the group the response stone joins
  bool captures;     // cap is not empty
};

// One candidate response of the prey at pt (a point): mirror of
// try_move in ladders._escaper_response_full. `on_prey`: pt is next to
// the prey (always for the extension).
template <int S>
__device__ __forceinline__ Resp try_move(const Lane<S>& s, const Ply& y,
                                         Pt pt, bool on_prey) {
  const uint32_t on = s.on(pt);
  const uint32_t ne = nbits(y.E1, pt, on), nc = nbits(y.C1, pt, on),
                 ng = nbits(y.gc, pt, on);
  int root[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) root[d] = s.lab_or_none(s.nbr(pt, d));
  int want[4];
  bool takes[4];
  bool gc_adj = false, prey_adj = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int r = root[d] >= 0 ? root[d] : 0;
    const int l = s.libs(r);
    const bool gained = y.captures && s.gained(r);
    const bool is_e = (ne >> d) & 1u, is_c = (nc >> d) & 1u,
               in_gc = (ng >> d) & 1u;
    gc_adj |= is_c && in_gc;
    // an adjacent chaser group in atari before the move, that gained
    // no liberty from the move's captures, is captured
    takes[d] = is_c && !in_gc && root[d] < s.n() && l == 1 && !gained;
    prey_adj |= is_e && root[d] == y.prey_root;
    want[d] = takes[d] || (is_e && root[d] != y.prey_root) ? root[d] : -1;
  }
  const Masks g = wanted(s, want);
  const bool gc_taken = gc_adj && y.gc_nlibs == 1;
  uint32_t esc = gc_taken ? y.gc : 0u;
  uint32_t cluster = s.one(pt) | (prey_adj ? y.pm : 0u);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    esc |= takes[d] ? g.m[d] : 0u;
    cluster |= takes[d] ? 0u : g.m[d];
  }
  const uint32_t empty2 = (y.empty1 & ~s.one(pt)) | esc;
  const uint32_t comp = on_prey ? (y.pm | cluster) : y.pm;
  const uint32_t comp_libs = empty2 & s.around(comp);
  const int libs2 = count(comp_libs);
  const int cluster_libs = count(empty2 & s.around(cluster));
  const bool empty_pt = !((ne | nc) & 16u);
  if (!(empty_pt && cluster_libs > 0)) return Resp{-1, 0, 0, 0, 0, false};
  return Resp{libs2, esc, comp, comp_libs, on_prey ? libs2 : cluster_libs,
              gc_taken || takes[0] || takes[1] || takes[2] || takes[3]};
}

struct Option {
  int o;              // the option's outcome for the chaser
  uint32_t cap0;      // prey-colour stones the chaser's move captures
  int gc_nlibs;       // liberties of the chaser group the move joins
  bool captures;      // cap0 is not empty
  Pt resp;            // the prey's response
  Resp r;             // and what it leaves
};

// Chaser fills lp: the chaser-move legality and captures of
// ladders._place, then the prey's forced response of
// ladders._escaper_response_full, all on the rung's pre-move labels.
// Returns early (ESCAPED) when the move is illegal or leaves the prey
// out of atari, which the reference scores ESCAPED whatever follows.
template <int S>
__device__ __forceinline__ Option option(const Lane<S>& s, Pt lp, Pt other,
                                         uint32_t E, uint32_t C,
                                         uint32_t pm, uint32_t dil_prey,
                                         int prey_root) {
  Option out{ESCAPED, 0, 0, false, no_point(), Resp{-1, 0, 0, 0, 0, false}};
  const uint32_t on = s.on(lp);
  const uint32_t ne = nbits(E, lp, on), nc = nbits(C, lp, on);
  int root[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) root[d] = s.lab_or_none(s.nbr(lp, d));
  int want[4];
  bool is_e[4];
  bool own_safe = false, takes = false;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int l = s.libs(root[d] >= 0 ? root[d] : s.n());
    is_e[d] = (ne >> d) & 1u;
    const bool is_c = (nc >> d) & 1u;
    takes |= is_e[d] && l == 1;
    own_safe |= is_c && l >= 2;
    want[d] = (is_e[d] && l == 1) || is_c ? root[d] : -1;
  }
  const uint32_t empty_nbrs = on & ~(ne | nc);
  const bool has_empty = empty_nbrs != 0, joins = (nc & 15u) != 0;
  const int empties = __popc(empty_nbrs);
  const bool empty_lp = !((ne | nc) & 16u);
  if (!(empty_lp && (has_empty || own_safe || takes))) return out;
  const Masks g = wanted(s, want);
  uint32_t cap0 = 0, gc = s.one(lp);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    cap0 |= is_e[d] ? g.m[d] : 0u;
    gc |= is_e[d] ? 0u : g.m[d];
  }
  out.cap0 = cap0;
  out.captures = takes;

  Ply y;
  y.E1 = E & ~cap0;
  y.C1 = C | s.one(lp);
  y.empty1 = s.rowmask & ~(y.E1 | y.C1);
  y.pm = pm;
  y.dil_prey = dil_prey;
  y.prey_root = prey_root;
  // with no capture the prey keeps exactly its other liberty, and a
  // lone chaser stone's liberties are its empty neighbours
  Pt ext = other;
  if (takes) {
    const uint32_t prey_libs1 = y.empty1 & dil_prey;
    if (count(prey_libs1) != 1) return out;
    ext = first(prey_libs1);
  }
  y.gc = gc;
  y.gc_nlibs = takes || joins ? count(y.empty1 & s.around(gc)) : empties;
  out.gc_nlibs = y.gc_nlibs;
  // chaser stones next to the captured stones: their groups gained a
  // liberty (flags by root, set for this option only)
  y.captures = takes;
  const uint32_t gained = y.captures ? y.C1 & s.dil(cap0) : 0u;
  if (y.captures) mark_gained(s, gained, 1);

  const Pt target = atari_target(s, y);
  Pt cap_pt = no_point();
  if (target.r >= 0) {
    const uint32_t tm = bit(gc, target) ? gc : group(s, s.lab(target));
    cap_pt = first(y.empty1 & s.dil(tm));
  }
  // the extension, then the counter-capture; L1 >= L2 keeps the first
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const Pt pt = k == 0 ? ext : cap_pt;
    if (pt.r < 0) break;
    const Resp r = try_move(s, y, pt, k == 0 || bit(dil_prey, pt));
    if (k == 0 || r.libs > out.r.libs) {
      out.r = r;
      out.resp = pt;
    }
  }
  if (y.captures) mark_gained(s, gained, 0);
  out.o = out.r.libs <= 1 ? CAPTURED
                          : (out.r.libs >= 3 ? ESCAPED : CONTINUE);
  return out;
}

// A stone of the colour whose rows are `own` lands on pt and `cap`
// (stones of the other colour) is removed. Labels: mirror of
// ladders._relabel_place (a placement only merges groups, a capture
// removes whole groups, so the min-root labels stay exact without a
// fill). Liberty table, when it is still exact and nothing was
// captured: each distinct other-colour root next to pt loses the
// liberty pt, and the merged group's root takes `joined_libs`; every
// other root keeps its count. Returns whether the table is exact.
template <int S>
__device__ __forceinline__ bool place_stone(const Lane<S>& s, Pt pt,
                                            uint32_t own, uint32_t other,
                                            uint32_t cap, bool captures,
                                            int joined_libs, bool table) {
  const uint32_t on = s.on(pt);
  const uint32_t no = nbits(own, pt, on), nt = nbits(other, pt, on);
  int mr[4], tr[4];
  int new_root = s.flat(pt);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int r = s.lab_or_none(s.nbr(pt, d));
    mr[d] = (no >> d) & 1u ? r : -1;
    tr[d] = (nt >> d) & 1u ? r : -1;
    new_root = mr[d] >= 0 ? min(new_root, mr[d]) : new_root;
  }
  bool moved = captures;  // does any label but pt's change?
#pragma unroll
  for (int d = 0; d < 4; ++d) moved |= mr[d] >= 0 && mr[d] != new_root;
  __syncwarp();  // every thread has read the roots it needs
  if (!moved) {
    if (s.row == pt.r) s.lab(pt) = new_root;
  } else {
    int4* row = &chase_smem[(s.lab_at + (s.live() ? s.row : 0) *
                                            Lane<S>::W) / 4];
    const uint32_t at_pt = s.one(pt);
    const int n = s.n();
#pragma unroll
    for (int i = 0; i < Lane<S>::W / 4; ++i) {
      int v[4];
      const int4 w = row[i];
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * i + j;
        const bool merged = ((at_pt >> c) & 1u) || v[j] == mr[0] ||
                            v[j] == mr[1] || v[j] == mr[2] || v[j] == mr[3];
        v[j] = ((cap >> c) & 1u) ? n : (merged ? new_root : v[j]);
      }
      if (s.live()) row[i] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  table = table && !captures;
  if (table) {
    // lane d < 4 takes neighbour d's root (first time it is seen),
    // lane 4 the merged root
    const int d = s.row;
    const int r = d == 0 ? tr[0] : (d == 1 ? tr[1] : (d == 2 ? tr[2] : tr[3]));
    const bool seen = d >= 4 || r < 0 || (d >= 1 && tr[0] == r) ||
                      (d >= 2 && tr[1] == r) || (d >= 3 && tr[2] == r);
    if (!seen) s.libs(r) -= 1;
    if (d == 4) s.libs(new_root) = joined_libs;
  }
  __syncwarp();
  return table;
}

template <int S>
__global__ void __launch_bounds__(kLanesPerBlock * 32)
chase_kernel(const int8_t* __restrict__ boards,
             const int32_t* __restrict__ labels,
             const int32_t* __restrict__ prey_pts,
             uint8_t* __restrict__ captured_out,
             uint8_t* __restrict__ core_out, int lanes, int size_arg,
             int depth) {
  constexpr int W = Lane<S>::W;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * kLanesPerBlock + warp;
  if (lane >= lanes) return;  // the whole warp
  Lane<S> s;
  s.size_arg = size_arg;
  s.row = threadIdx.x & 31;
  const int size = s.size(), n = s.n();
  s.rowmask = s.live() ? (size == 32 ? kFull : (1u << size) - 1u) : 0u;
  const int lab_words = size * W, libs_words = (n + 33 + 3) / 4 * 4;
  const int per_warp = lab_words + libs_words + (n + 16) / 16 * 4;
  s.lab_at = warp * per_warp;
  s.libs_at = s.lab_at + lab_words;
  s.gained_at = 4 * (s.libs_at + libs_words);

  const size_t base = static_cast<size_t>(lane) * n;
  const int P = prey_pts[lane];
  const bool enabled = P >= 0 && P < n;
  const int prey_color = enabled ? boards[base + P] : 0;
  const Pt pp = enabled ? Pt{P / size, P - P / size * size} : no_point();

  // E: prey-colour stones, C: chaser stones, one row per thread
  uint32_t E = 0, C = 0;
  if (s.live()) {
    const size_t off = base + static_cast<size_t>(s.row) * size;
    int lr[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      lr[c] = n;
      if (S == 0 && c >= size) continue;
      if (S > 0 && c >= S) continue;
      const int v = boards[off + c];
      E |= static_cast<uint32_t>(v != 0 && v == prey_color) << c;
      C |= static_cast<uint32_t>(v != 0 && v == -prey_color) << c;
      lr[c] = labels[off + c];
    }
    int4* row = &chase_smem[(s.lab_at + s.row * W) / 4];
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      row[i] = make_int4(lr[4 * i], lr[4 * i + 1], lr[4 * i + 2],
                         lr[4 * i + 3]);
  }
  for (int i = s.row; i <= n; i += 32) s.gained(i) = 0;
  __syncwarp();

  uint32_t core = 0;
  bool captured = false;
  bool done = !enabled;
  if (enabled && prey_color == 0 && depth > 0) {
    // an empty prey point: its label is n, which has no liberties, so
    // the first rung reads ESCAPED with the prey point as the core
    core = s.one(pp);
    done = true;
  }
  // After a continuing rung the next one starts from what the chosen
  // response left: the prey group, its two liberties and an updated
  // liberty table (rebuilt only after a capture).
  bool carried = false, table = false;
  uint32_t pm = 0, lib_pts = 0;
  for (int rung = 0; rung < depth && !done; ++rung) {
    const uint32_t stones = E | C;
    const uint32_t empty0 = s.rowmask & ~stones;
    if (!table) liberty_table(s, empty0 & s.around(stones));
    const int prey_root = s.lab(pp);
    bool prey_alive = true;
    int L = 2;
    if (!carried) {
      prey_alive = bit(E, pp);
      L = prey_alive ? s.libs(prey_root) : 0;
      pm = group(s, prey_root);
      lib_pts = s.around(pm) & empty0;
    }
    const uint32_t E0 = E, C0 = C, pm0 = pm;

    int o = !prey_alive ? CAPTURED
                        : (L >= 3 ? ESCAPED
                                  : (L == 1 ? CAPTURED
                                            : (L == 2 ? -1 : ESCAPED)));
    if (o < 0) {
      const uint32_t dil_prey = pm | s.around(pm);
      Pt l1, l2;
      first2(lib_pts, &l1, &l2);
      // the two options; o1 <= o2 keeps the first, so a capture by the
      // first settles the rung
      Option best;
      Pt c_pt = l1;
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        const Pt lp = k == 0 ? l1 : l2;
        const Option x =
            option(s, lp, k == 0 ? l2 : l1, E, C, pm, dil_prey, prey_root);
        if (k == 0 || x.o < best.o) {
          best = x;
          c_pt = lp;
        }
        if (best.o == CAPTURED) break;
      }
      o = best.o;
      if (o == CONTINUE) {
        // the chaser's move, then the prey's response
        table = true;
#pragma unroll 1
        for (int ply = 0; ply < 2; ++ply) {
          const Pt pt = ply == 0 ? c_pt : best.resp;
          const uint32_t cap = ply == 0 ? best.cap0 : best.r.cap;
          table = place_stone(
              s, pt, ply == 0 ? C : E, ply == 0 ? E : C, cap,
              ply == 0 ? best.captures : best.r.captures,
              ply == 0 ? best.gc_nlibs : best.r.own_libs, table);
          const uint32_t at_pt = s.one(pt);
          E = ply == 0 ? E & ~cap : E | at_pt;
          C = ply == 0 ? C | at_pt : C & ~cap;
        }
        pm = best.r.prey;
        lib_pts = best.r.prey_libs;
        carried = true;
      }
    }
    core |= (pm0 & (E0 | C0)) | s.one(pp) | (E ^ E0) | (C ^ C0);
    captured = o == CAPTURED;
    done = o != CONTINUE;
  }

  if (core_out != nullptr && s.live()) {
    const size_t off = base + static_cast<size_t>(s.row) * size;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (S == 0 && c >= size) continue;
      if (S > 0 && c >= S) continue;
      core_out[off + c] = enabled && ((core >> c) & 1u);
    }
  }
  if (s.row == 0) captured_out[lane] = enabled && captured;
}

template <int S>
void launch(const void* boards, const void* labels, const void* prey,
            void* captured, void* core, int lanes, int size, int depth,
            cudaStream_t stream) {
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  const int n = size * size;
  const size_t per_warp = static_cast<size_t>(size) * kStride<S> +
                          (n + 33 + 3) / 4 * 4 + (n + 16) / 16 * 4;
  const size_t shmem = kLanesPerBlock * per_warp * sizeof(int32_t);
  chase_kernel<S><<<blocks, kLanesPerBlock * 32, shmem, stream>>>(
      static_cast<const int8_t*>(boards), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(prey), static_cast<uint8_t*>(captured),
      static_cast<uint8_t*>(core), lanes, size, depth);
}

}  // namespace

// boards int8 [lanes, n]; labels int32 [lanes, n] (carried min-root
// labels); prey int32 [lanes] (flat prey point, negative = disabled);
// captured uint8 [lanes]; core uint8 [lanes, n] or null; size <= 32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rocalphago_chase(const void* boards, const void* labels,
                                const void* prey, void* captured, void* core,
                                int lanes, int size, int depth,
                                void* stream) {
  if (lanes <= 0 || size <= 0 || size > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (size) {
    case 9: launch<9>(boards, labels, prey, captured, core, lanes, size,
                      depth, st); break;
    case 13: launch<13>(boards, labels, prey, captured, core, lanes, size,
                        depth, st); break;
    case 19: launch<19>(boards, labels, prey, captured, core, lanes, size,
                        depth, st); break;
    case 25: launch<25>(boards, labels, prey, captured, core, lanes, size,
                        depth, st); break;
    default: launch<0>(boards, labels, prey, captured, core, lanes, size,
                       depth, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
