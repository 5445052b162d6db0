// tapenv.cc — native C++ implementation of the TAP environment family.
//
// Third executable implementation of SPEC.md (next to the numpy oracle and
// the JAX/Pallas env), exposed over a C ABI for ctypes. Role in the
// framework (SURVEY.md §2.2: the reference has no native tier; this is the
// TPU-framework's host-side runtime piece):
//   * fast, JAX-free plan validation / env stepping for serving pipelines
//     and data tooling on hosts without accelerators;
//   * a differential-testing partner: C++ vs oracle vs JAX vs Pallas must
//     agree bit-for-bit on trajectories (tests/test_native.py).
//
// Semantics are SPEC.md §3-§10 exactly: integer heightmaps, lowest/leftmost/
// frontmost tie-break via the injective key ((l*Wt)+x)*Dt+y, soft/hard
// stability variants, rolling window, multi-container, no-op steps.
// RNG parity: the "random" policy consumes caller-provided threefry bits
// (one uint32 per decode step), so C++ and JAX draw identical actions.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC tapenv.cc -o libtapenv.so -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Cfg {
  int dim, N, Wt, Dt, Ht, C, R, window, hard;
  int rule;   // 0 = lb (left-bottom greedy), 1 = mcs (max candidate score)
  int terms;  // reward-term bitmask for mcs scoring: 1 = C, 2 = P, 4 = S
};

struct Candidate {
  int x, y, l, stable;
  bool valid = false;
};

// Per-instance rollout working state.
struct Env {
  const Cfg& cfg;
  const int32_t* dims;    // [N, 3]
  int32_t n_total;
  const uint8_t* up;      // [N, N]
  const uint8_t* rot;     // [N, N]
  std::vector<int32_t> hm;        // [C, Wt, Dt]
  std::vector<uint8_t> packed;    // [N]
  std::vector<int32_t> place;     // [N, 6] = (c, r, x, y, l, stable)
  std::vector<uint8_t> mask;      // [N*R*C]

  Env(const Cfg& c, const int32_t* d, int32_t nt, const uint8_t* u,
      const uint8_t* r)
      : cfg(c), dims(d), n_total(nt), up(u), rot(r),
        hm(c.C * c.Wt * c.Dt, 0), packed(c.N, 0), place(c.N * 6, -1),
        mask(c.N * c.R * c.C, 0) {
    for (int b = n_total; b < cfg.N; ++b) packed[b] = 1;  // padding
  }

  int32_t& hm_at(int c, int x, int y) {
    return hm[(c * cfg.Wt + x) * cfg.Dt + y];
  }

  void rotated_dims(int b, int r, int* w, int* d, int* h) const {
    int w0 = dims[b * 3], d0 = dims[b * 3 + 1], h0 = dims[b * 3 + 2];
    if (r == 1) {
      if (cfg.dim == 2) { *w = h0; *d = d0; *h = w0; }   // swap (x, z)
      else              { *w = d0; *d = w0; *h = h0; }   // swap (x, y)
    } else { *w = w0; *d = d0; *h = h0; }
  }

  bool accessible(int b, int r) const {               // SPEC §3
    for (int a = 0; a < cfg.N; ++a) {
      if (packed[a]) continue;
      if (up[a * cfg.N + b]) return false;
      if (r == 1 && rot[a * cfg.N + b]) return false;
    }
    return true;
  }

  bool in_window(int b) const {                       // SPEC §8
    if (cfg.window <= 0) return true;
    int rank = 0;
    for (int a = 0; a < cfg.N; ++a) {
      bool acc = !packed[a] && accessible(a, 0);
      if (a == b) return acc && rank < cfg.window;
      if (acc) ++rank;
    }
    return false;
  }

  // Cheap existence check (SPEC §5): feasibility is rule-independent.
  bool has_candidate(int c, int w, int d, int h) {
    for (int x = 0; x + w <= cfg.Wt; ++x)
      for (int y = 0; y + d <= cfg.Dt; ++y) {
        int l = 0;
        for (int i = x; i < x + w; ++i)
          for (int j = y; j < y + d; ++j)
            if (hm_at(c, i, j) > l) l = hm_at(c, i, j);
        if (cfg.Ht <= 0 || l + h <= cfg.Ht) return true;
      }
    return false;
  }

  // SPEC §6.4 mcs: exact score fraction n/d of the hypothetical state after
  // placing at (x, y, l, stable); fits __int128 (config-level bound check).
  void mcs_score(int c, int x, int y, int l, int stable, int w, int d, int h,
                 const int64_t agg[5], __int128* n_out, __int128* d_out) {
    int64_t vol = agg[0], denom_c = agg[1], denom_p = agg[2];
    int64_t s_num = agg[3], s_den = agg[4];
    int64_t curmax = 0, fpsum = 0;
    for (int i = 0; i < cfg.Wt; ++i)
      for (int j = 0; j < cfg.Dt; ++j) {
        int32_t v = hm_at(c, i, j);
        if (v > curmax) curmax = v;
        if (i >= x && i < x + w && j >= y && j < y + d) fpsum += v;
      }
    int64_t top = l + h;
    int64_t dc = denom_c + (int64_t)cfg.Wt * cfg.Dt *
                               ((top > curmax ? top : curmax) - curmax);
    int64_t dp = denom_p + (int64_t)w * d * top - fpsum;
    int64_t vp = vol + (int64_t)w * d * h;
    int64_t sn = s_num + stable, sd = s_den + 1;
    __int128 n = 0, dd = 1;
    const int64_t nums[3] = {vp, vp, sn};
    const int64_t dens[3] = {dc, dp, sd};
    for (int t = 0; t < 3; ++t) {
      if (!(cfg.terms & (1 << t))) continue;
      n = n * dens[t] + (__int128)nums[t] * dd;
      dd = dd * dens[t];
    }
    *n_out = n;
    *d_out = dd;
  }

  // SPEC §6: best candidate in container c for footprint (w, d), height h.
  Candidate best_candidate(int c, int w, int d, int h) {
    const int Wt = cfg.Wt, Dt = cfg.Dt;
    Candidate soft, hard_c;
    int64_t soft_key = INT64_MAX, hard_key = INT64_MAX;
    __int128 soft_n = 0, soft_d = 0, hard_n = 0, hard_d = 0;  // mcs scores
    int64_t agg[5] = {0, 0, 0, 0, 0};
    if (cfg.rule == 1) {
      int32_t t32[5];
      reward_terms(t32);
      for (int i = 0; i < 5; ++i) agg[i] = t32[i];
    }
    for (int x = 0; x + w <= Wt; ++x) {
      for (int y = 0; y + d <= Dt; ++y) {
        int l = 0;
        for (int i = x; i < x + w; ++i)
          for (int j = y; j < y + d; ++j)
            if (hm_at(c, i, j) > l) l = hm_at(c, i, j);
        if (cfg.Ht > 0 && l + h > cfg.Ht) continue;
        // stability: support bbox contains footprint center (doubled coords)
        int stable;
        if (l == 0) {
          stable = 1;
        } else {
          int mini = INT32_MAX, maxi = INT32_MIN, minj = INT32_MAX,
              maxj = INT32_MIN;
          for (int i = x; i < x + w; ++i)
            for (int j = y; j < y + d; ++j)
              if (hm_at(c, i, j) == l) {
                if (i < mini) mini = i;
                if (i > maxi) maxi = i;
                if (j < minj) minj = j;
                if (j > maxj) maxj = j;
              }
          int cx2 = 2 * x + w - 1, cy2 = 2 * y + d - 1;
          stable = (2 * mini <= cx2 && cx2 <= 2 * maxi &&
                    2 * minj <= cy2 && cy2 <= 2 * maxj);
        }
        int64_t key = ((int64_t)l * Wt + x) * Dt + y;
        if (cfg.rule == 1) {  // mcs: max exact score, ties -> min lb key
          __int128 n, dd;
          mcs_score(c, x, y, l, stable, w, d, h, agg, &n, &dd);
          auto better = [&](__int128 bn, __int128 bd, int64_t bkey) {
            if (bd == 0) return true;  // no incumbent yet
            __int128 lhs = n * bd, rhs = bn * dd;
            return lhs > rhs || (lhs == rhs && key < bkey);
          };
          if (better(soft_n, soft_d, soft_key)) {
            soft_key = key; soft_n = n; soft_d = dd;
            soft = {x, y, l, stable, true};
          }
          if (stable && better(hard_n, hard_d, hard_key)) {
            hard_key = key; hard_n = n; hard_d = dd;
            hard_c = {x, y, l, stable, true};
          }
        } else {  // lb: min key
          if (key < soft_key) { soft_key = key; soft = {x, y, l, stable, true}; }
          if (stable && key < hard_key) {
            hard_key = key;
            hard_c = {x, y, l, stable, true};
          }
        }
      }
    }
    if (cfg.hard && hard_c.valid) return hard_c;
    return soft;  // hard falls back to soft (recorded unstable), SPEC §6.4
  }

  void compute_mask() {                               // SPEC §5
    std::fill(mask.begin(), mask.end(), 0);
    for (int b = 0; b < cfg.N; ++b) {
      if (b >= n_total || packed[b]) continue;
      if (!in_window(b)) continue;
      for (int r = 0; r < cfg.R; ++r) {
        if (!accessible(b, r)) continue;
        int w, d, h;
        rotated_dims(b, r, &w, &d, &h);
        if (w > cfg.Wt || d > cfg.Dt) continue;
        for (int c = 0; c < cfg.C; ++c) {
          if (cfg.Ht > 0 && !has_candidate(c, w, d, h)) continue;
          mask[(b * cfg.R + r) * cfg.C + c] = 1;
        }
      }
    }
  }

  // Apply action a (must be mask-feasible). Returns false if placement
  // impossible (no valid candidate), in which case nothing changes.
  bool step(int a) {
    int b = a / (cfg.R * cfg.C), r = (a / cfg.C) % cfg.R, c = a % cfg.C;
    int w, d, h;
    rotated_dims(b, r, &w, &d, &h);
    Candidate best = best_candidate(c, w, d, h);
    if (!best.valid) return false;
    for (int i = best.x; i < best.x + w; ++i)
      for (int j = best.y; j < best.y + d; ++j)
        hm_at(c, i, j) = best.l + h;
    packed[b] = 1;
    int32_t* row = &place[b * 6];
    row[0] = c; row[1] = r; row[2] = best.x; row[3] = best.y;
    row[4] = best.l; row[5] = best.stable;
    return true;
  }

  void reward_terms(int32_t* out) const {             // SPEC §7
    int64_t vol = 0, denom_c = 0, denom_p = 0, s_num = 0, s_den = 0;
    for (int b = 0; b < cfg.N; ++b) {
      if (place[b * 6] < 0) continue;
      vol += (int64_t)dims[b * 3] * dims[b * 3 + 1] * dims[b * 3 + 2];
      s_num += place[b * 6 + 5];
      s_den += 1;
    }
    for (int c = 0; c < cfg.C; ++c) {
      int32_t maxh = 0;
      int64_t under = 0;
      for (int x = 0; x < cfg.Wt; ++x)
        for (int y = 0; y < cfg.Dt; ++y) {
          int32_t v = hm[(c * cfg.Wt + x) * cfg.Dt + y];
          if (v > maxh) maxh = v;
          under += v;
        }
      if (maxh > 0) {
        denom_c += (int64_t)cfg.Wt * cfg.Dt * maxh;
        denom_p += under;
      }
    }
    out[0] = (int32_t)vol; out[1] = (int32_t)denom_c;
    out[2] = (int32_t)denom_p; out[3] = (int32_t)s_num;
    out[4] = (int32_t)s_den;
  }
};

enum Policy { REPLAY = 0, FIRST = 1, RANDOM = 2 };

void rollout_one(const Cfg& cfg, const int32_t* dims, int32_t n_total,
                 const uint8_t* up, const uint8_t* rot, int policy,
                 const int32_t* actions_in, const uint32_t* rbits,
                 int32_t* actions_out, int32_t* hm_out, uint8_t* packed_out,
                 int32_t* place_out, int32_t* terms_out) {
  Env env(cfg, dims, n_total, up, rot);
  const int A = cfg.N * cfg.R * cfg.C;
  for (int t = 0; t < cfg.N; ++t) {
    env.compute_mask();
    int n_feas = 0;
    for (int a = 0; a < A; ++a) n_feas += env.mask[a];
    int a = -1;
    if (policy == REPLAY) {
      int cand = actions_in[t];
      if (cand >= 0 && cand < A && env.mask[cand]) a = cand;
    } else if (n_feas > 0) {
      int k = (policy == FIRST) ? 0 : (int)(rbits[t] % (uint32_t)n_feas);
      for (int i = 0; i < A; ++i)
        if (env.mask[i] && k-- == 0) { a = i; break; }
    }
    if (a >= 0 && !env.step(a)) a = -1;  // unplaceable: no-op (SPEC §5)
    actions_out[t] = a;
  }
  std::memcpy(hm_out, env.hm.data(), env.hm.size() * sizeof(int32_t));
  std::memcpy(packed_out, env.packed.data(), env.packed.size());
  std::memcpy(place_out, env.place.data(), env.place.size() * sizeof(int32_t));
  env.reward_terms(terms_out);
}

}  // namespace

extern "C" {

// Batched rollout; arrays are C-contiguous with the documented shapes.
// policy: 0 = replay actions_in [B,N] (infeasible entries become no-ops and
// read back -1 in actions_out — plan validation), 1 = first, 2 = random
// (consumes rbits [B,N]). Returns 0 on success.
int tap_rollout_batch(
    int B, int dim, int N, int Wt, int Dt, int Ht, int C, int R, int window,
    int hard,
    int rule,        // 0 = lb, 1 = mcs (SPEC §6.4)
    int terms_mask,  // mcs term bitmask: 1 = C, 2 = P, 4 = S
    const int32_t* dims,        // [B, N, 3]
    const int32_t* n_total,     // [B]
    const uint8_t* up,          // [B, N, N]
    const uint8_t* rot,         // [B, N, N]
    int policy,
    const int32_t* actions_in,  // [B, N] or nullptr
    const uint32_t* rbits,      // [B, N] or nullptr
    int32_t* actions_out,       // [B, N]
    int32_t* heightmaps,        // [B, C, Wt, Dt]
    uint8_t* packed,            // [B, N]
    int32_t* placements,        // [B, N, 6]
    int32_t* terms,             // [B, 5]
    int n_threads) {
  if (policy == REPLAY && actions_in == nullptr) return 1;
  if (policy == RANDOM && rbits == nullptr) return 2;
  Cfg cfg{dim, N, Wt, Dt, Ht, C, R, window, hard, rule, terms_mask};
  auto work = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      rollout_one(cfg, dims + (size_t)i * N * 3, n_total[i],
                  up + (size_t)i * N * N, rot + (size_t)i * N * N, policy,
                  actions_in ? actions_in + (size_t)i * N : nullptr,
                  rbits ? rbits + (size_t)i * N : nullptr,
                  actions_out + (size_t)i * N,
                  heightmaps + (size_t)i * C * Wt * Dt,
                  packed + (size_t)i * N, placements + (size_t)i * N * 6,
                  terms + (size_t)i * 5);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || B < 2) {
    work(0, B);
  } else {
    std::vector<std::thread> threads;
    int chunk = (B + nt - 1) / nt;
    for (int s = 0; s < B; s += chunk)
      threads.emplace_back(work, s, std::min(B, s + chunk));
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
