// Go game replayer for corpus conversion, built for the host.
//
// Role: the host-side rules loop of SGF->training-data conversion
// (rocalphago_tpu_torch/data/convert.py). Feature encoding and
// training run on the card; this replaces only the per-move Python
// rules bookkeeping (pygo.GameState.do_move) when walking millions of
// recorded positions. A copy of the reference package's
// native/goreplay.cpp, built by rocalphago_tpu_torch/data/native.py.
//
// Semantics mirror rocalphago_tpu_torch.engine.pygo exactly:
//   * captures via liberty-less opponent groups, suicide illegal,
//   * simple ko (single capture by a lone stone left with exactly one
//     liberty bans the captured point),
//   * stone_ages[p] = turns_played at placement (-1 when empty),
//   * two consecutive passes end the game; later moves are illegal,
//   * handicap/setup stones get age 0.
//
// API (extern "C", ctypes-friendly): go_replay() writes the pre-move
// snapshot of every ply (board, player to move, recorded mover, ko,
// step count, stone ages) and returns the ply count, or -(k+1) if the
// k-th move is illegal.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int8_t EMPTY = 0;

struct Board {
    int size = 0;
    int n = 0;
    std::vector<int8_t> stones;
    std::vector<int32_t> ages;
    int32_t ko = -1;          // flat point banned by simple ko, -1 none
    int32_t turns = 0;
    int8_t to_move = 1;       // black
    int passes = 0;           // consecutive
    bool over = false;

    void init(int s) {
        size = s;
        n = s * s;
        stones.assign(n, EMPTY);
        ages.assign(n, -1);
    }

    inline int neighbors(int p, int out[4]) const {
        const int x = p / size, y = p % size;
        int k = 0;
        if (x > 0) out[k++] = p - size;
        if (x + 1 < size) out[k++] = p + size;
        if (y > 0) out[k++] = p - 1;
        if (y + 1 < size) out[k++] = p + 1;
        return k;
    }

    // Flood-fill the group at `p` on `b`; returns stone count and
    // whether it has at least `min_libs` liberties (early exit).
    int group(const std::vector<int8_t>& b, int p,
              std::vector<int32_t>& stack, std::vector<uint8_t>& seen,
              bool* has_lib) const {
        const int8_t color = b[p];
        stack.clear();
        std::fill(seen.begin(), seen.end(), 0);
        stack.push_back(p);
        seen[p] = 1;
        int count = 0;
        bool lib = false;
        int nb[4];
        while (!stack.empty()) {
            const int q = stack.back();
            stack.pop_back();
            ++count;
            const int k = neighbors(q, nb);
            for (int i = 0; i < k; ++i) {
                const int r = nb[i];
                if (b[r] == EMPTY) {
                    lib = true;
                } else if (b[r] == color && !seen[r]) {
                    seen[r] = 1;
                    stack.push_back(r);
                }
            }
        }
        *has_lib = lib;
        return count;
    }

    void remove_group(std::vector<int8_t>& b, int p,
                      std::vector<int32_t>& removed) const {
        const int8_t color = b[p];
        std::vector<int32_t> stack{p};
        b[p] = EMPTY;
        removed.push_back(p);
        int nb[4];
        while (!stack.empty()) {
            const int q = stack.back();
            stack.pop_back();
            const int k = neighbors(q, nb);
            for (int i = 0; i < k; ++i) {
                const int r = nb[i];
                if (b[r] == color) {
                    b[r] = EMPTY;
                    removed.push_back(r);
                    stack.push_back(r);
                }
            }
        }
    }

    // Apply a move; returns false if illegal. `action == n` is a pass.
    bool play(int32_t action, int8_t color,
              std::vector<int32_t>& scratch_stack,
              std::vector<uint8_t>& scratch_seen) {
        if (over) return false;
        if (action == n) {
            ko = -1;
            ++turns;
            to_move = static_cast<int8_t>(-color);
            if (++passes >= 2) over = true;
            return true;
        }
        passes = 0;
        if (action < 0 || action > n) return false;
        if (stones[action] != EMPTY) return false;
        if (ko == action) return false;

        std::vector<int8_t> b = stones;
        b[action] = color;
        std::vector<int32_t> captured;
        int nb[4];
        const int k = neighbors(action, nb);
        for (int i = 0; i < k; ++i) {
            const int r = nb[i];
            if (b[r] == -color) {
                bool has_lib = false;
                group(b, r, scratch_stack, scratch_seen, &has_lib);
                if (!has_lib) remove_group(b, r, captured);
            }
        }
        bool own_lib = false;
        const int own_count =
            group(b, action, scratch_stack, scratch_seen, &own_lib);
        if (!own_lib) return false;  // suicide

        // simple ko: lone stone capturing exactly one, left in atari
        ko = -1;
        if (captured.size() == 1 && own_count == 1) {
            int libs = 0;
            for (int i = 0; i < k; ++i)
                if (b[nb[i]] == EMPTY) ++libs;
            if (libs == 1) ko = captured[0];
        }

        stones.swap(b);
        for (const int32_t p : captured) ages[p] = -1;
        ages[action] = turns;
        ++turns;
        to_move = static_cast<int8_t>(-color);
        return true;
    }
};

}  // namespace

extern "C" {

// Writes pre-move snapshots for each of n_moves plies. Returns
// n_moves on success, -(k+1) if ply k is illegal (including setup
// collisions reported as ply 0).
int go_replay(int size,
              const int32_t* setup_black, int n_sb,
              const int32_t* setup_white, int n_sw,
              const int32_t* moves, const int8_t* colors, int n_moves,
              int8_t* out_boards,    // [n_moves * size*size]
              int8_t* out_to_move,   // [n_moves]
              int32_t* out_kos,      // [n_moves]
              int32_t* out_steps,    // [n_moves]
              int32_t* out_ages) {   // [n_moves * size*size]
    if (size < 2 || size > 25) return -1;
    Board bd;
    bd.init(size);
    for (int i = 0; i < n_sb; ++i) {
        const int32_t p = setup_black[i];
        if (p < 0 || p >= bd.n || bd.stones[p] != EMPTY) return -1;
        bd.stones[p] = 1;
        bd.ages[p] = 0;
    }
    for (int i = 0; i < n_sw; ++i) {
        const int32_t p = setup_white[i];
        if (p < 0 || p >= bd.n || bd.stones[p] != EMPTY) return -1;
        bd.stones[p] = -1;
        bd.ages[p] = 0;
    }
    if (n_moves > 0) bd.to_move = colors[0];

    std::vector<int32_t> scratch_stack;
    scratch_stack.reserve(bd.n);
    std::vector<uint8_t> scratch_seen(bd.n);

    for (int m = 0; m < n_moves; ++m) {
        std::memcpy(out_boards + static_cast<size_t>(m) * bd.n,
                    bd.stones.data(), bd.n);
        out_to_move[m] = bd.to_move;
        out_kos[m] = bd.ko;
        out_steps[m] = bd.turns;
        std::memcpy(out_ages + static_cast<size_t>(m) * bd.n,
                    bd.ages.data(),
                    static_cast<size_t>(bd.n) * sizeof(int32_t));
        if (!bd.play(moves[m], colors[m], scratch_stack, scratch_seen))
            return -(m + 1);
    }
    return n_moves;
}

}  // extern "C"
