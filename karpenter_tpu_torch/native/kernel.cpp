// Native (host) implementation of the grouped feasibility + pack kernel.
//
// Mirrors karpenter_tpu/ops/kernels.py::solve_step over the exact same
// tensorized snapshot layout (see ops/tensorize.py): requirement sets as
// packed uint32 bitmasks over interned vocabularies, groups in FFD order,
// bins accumulating the intersection of surviving instance types. This is
// the fallback engine when no accelerator is available — the TPU-native
// reformulation of the reference's Go scheduling loop (scheduler.go:195-296)
// compiled for the host instead of for XLA.
//
// Differences from the device kernel, none observable in results:
// - emptiest-first filling is done directly with a priority scan instead of
//   the batched level-search (same fixpoint as scheduler.go:258's ascending
//   pod-count ordering);
// - per-bin candidate types are kept as shrinking index lists instead of a
//   dense [B,T] mask.
//
// C ABI for ctypes; all arrays are C-contiguous, caller-allocated.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

constexpr float EPS = 1e-6f;

struct Bin {
    int npods = 0;
    int tmpl = 0;
    std::vector<float> load;          // [R]
    std::vector<int> types;           // surviving candidate type ids
    std::vector<uint32_t> mask;       // [K*W] accumulated requirement mask
    std::vector<uint8_t> has;         // [K]
    std::vector<uint32_t> decl;       // [CW] hostname-anti classes declared
    std::vector<uint32_t> match;      // [CW] hostname-anti classes matched
    std::vector<int32_t> scnt;        // [C] spread-class matched-pod counts
    std::vector<int32_t> aff;         // [A] affinity-class matched-pod counts
};

// hostname pod-affinity classes (mirrors ops/kernels.py baff): a group
// OWNING class a may only land on bins whose matched count is already
// positive (nextDomainAffinity options, topology.py:209)
inline bool aff_ok(const Bin& bin, const uint8_t* aneed_g, int A) {
    for (int a = 0; a < A; ++a)
        if (aneed_g[a] && bin.aff[a] <= 0) return false;
    return true;
}

// hostname anti-affinity conflict classes (mirrors ops/kernels.py:199-203):
// a bin hosting pods MATCHED by class c excludes groups DECLARING c and
// vice versa (the direct/inverse TopologyGroup pair, topology.go:225)
inline bool anti_ok(const Bin& bin, const uint32_t* decl_g,
                    const uint32_t* match_g, int CW) {
    for (int w = 0; w < CW; ++w) {
        if ((bin.match[w] & decl_g[w]) || (bin.decl[w] & match_g[w]))
            return false;
    }
    return true;
}

// keep in sync with ops/tensorize.py SPREAD_OWNED_MIN / UNCAPPED
constexpr int32_t SPREAD_UNCAPPED = 1 << 29;

// hostname spread classes (mirrors ops/kernels.py bscnt): counts by
// selector match, cap enforced for owner groups (topologygroup.go:167).
// A self-selecting owner debits its own take; a non-self-selecting owner
// never raises the count it is checked against, so the cap gates the bin
// all-or-nothing (topology.py:200 'if self_selecting').
inline int spread_cap(const Bin& bin, const int32_t* sown_g,
                      const uint8_t* smatch_g, int C) {
    int cap = 1 << 30;
    for (int c = 0; c < C; ++c) {
        if (sown_g[c] >= SPREAD_UNCAPPED) continue;
        int rem = sown_g[c] - bin.scnt[c];
        if (!smatch_g[c]) rem = rem > 0 ? (1 << 30) : 0;
        cap = std::min(cap, rem > 0 ? rem : 0);
    }
    return cap;
}

inline bool masks_compatible(const uint32_t* a_mask, const uint8_t* a_has,
                             const uint32_t* b_mask, const uint8_t* b_has,
                             int K, int W,
                             // empty meet tolerated iff BOTH operators are
                             // NotIn/DoesNotExist (requirements.py:249);
                             // null = no tolerance (bin-accumulated masks)
                             const uint8_t* a_tol = nullptr,
                             const uint8_t* b_tol = nullptr) {
    for (int k = 0; k < K; ++k) {
        if (!a_has[k] || !b_has[k]) continue;
        if (a_tol && b_tol && a_tol[k] && b_tol[k]) continue;
        const uint32_t* aw = a_mask + (size_t)k * W;
        const uint32_t* bw = b_mask + (size_t)k * W;
        bool overlap = false;
        for (int w = 0; w < W; ++w) {
            if (aw[w] & bw[w]) { overlap = true; break; }
        }
        if (!overlap) return false;
    }
    return true;
}

inline void combine_masks(std::vector<uint32_t>& mask, std::vector<uint8_t>& has,
                          const uint32_t* gm, const uint8_t* gh, int K, int W) {
    for (int k = 0; k < K; ++k) {
        uint32_t* mw = mask.data() + (size_t)k * W;
        const uint32_t* gw = gm + (size_t)k * W;
        if (has[k] && gh[k]) {
            for (int w = 0; w < W; ++w) mw[w] &= gw[w];
        } else if (gh[k]) {
            for (int w = 0; w < W; ++w) mw[w] = gw[w];
        }
        has[k] = has[k] || gh[k];
    }
}

// minValues floor (cloudprovider/types.go:165-199): a take of t keeps
// >= minv instance types alive iff at least minv candidate capacities are
// >= t, i.e. t <= the minv-th largest capacity. caps is clobbered.
inline int minv_cap(std::vector<int>& caps, int minv) {
    if ((int)caps.size() < minv) return 0;
    std::nth_element(caps.begin(), caps.begin() + (minv - 1), caps.end(),
                     std::greater<int>());
    return caps[minv - 1];
}

// pods of demand d that fit into remaining space (alloc - load)
inline int cap_for(const float* alloc, const float* load, const float* d, int R) {
    float cap = std::numeric_limits<float>::infinity();
    for (int r = 0; r < R; ++r) {
        if (d[r] <= 0.0f) continue;
        float avail = alloc[r] - (load ? load[r] : 0.0f);
        float c = avail / std::max(d[r], EPS);
        cap = std::min(cap, c);
    }
    if (std::isinf(cap)) return 1 << 30;
    float f = std::floor(cap + EPS);
    return f <= 0.0f ? 0 : (int)f;
}

// every array the pack consults EXCEPT g_count/e_avail — the probe batch
// entry varies those two per counterfactual row over one shared snapshot
struct SolveShared {
    int G, T, K, W, R, M, O, B, Vz, Vc, CW, C, A, E;
    const uint32_t* g_mask; const uint8_t* g_has; const uint8_t* g_tol;
    const float* g_demand;
    const uint8_t* g_zone_allowed; const uint8_t* g_ct_allowed;
    const uint8_t* g_tmpl_ok;
    const int32_t* g_bin_cap; const uint8_t* g_single;
    const uint32_t* g_decl; const uint32_t* g_match;
    const int32_t* g_sown; const uint8_t* g_smatch;
    const uint8_t* g_aneed; const uint8_t* g_amatch;
    const uint8_t* ge_ok;
    const int32_t* e_npods; const int32_t* e_scnt;
    const uint32_t* e_decl; const uint32_t* e_match; const int32_t* e_aff;
    const uint32_t* t_mask; const uint8_t* t_has; const uint8_t* t_tol;
    const float* t_alloc; const float* t_cap; const int32_t* t_tmpl;
    const int32_t* off_zone; const int32_t* off_ct; const uint8_t* off_avail;
    const uint32_t* m_mask; const uint8_t* m_has; const uint8_t* m_tol;
    const float* m_overhead; const float* m_limits; const int32_t* m_minv;
};

// ---- feasibility: F[g,t] = requirement ∧ fit-one ∧ offering ----
static void build_feasibility(const SolveShared& s, std::vector<uint8_t>& F) {
    const int G = s.G, T = s.T, K = s.K, W = s.W, R = s.R, O = s.O;
    const int Vz = s.Vz, Vc = s.Vc;
    for (int g = 0; g < G; ++g) {
        const uint32_t* gm = s.g_mask + (size_t)g * K * W;
        const uint8_t* gh = s.g_has + (size_t)g * K;
        const float* d = s.g_demand + (size_t)g * R;
        const uint8_t* gt = s.g_tol + (size_t)g * K;
        for (int t = 0; t < T; ++t) {
            if (!masks_compatible(gm, gh, s.t_mask + (size_t)t * K * W,
                                  s.t_has + (size_t)t * K, K, W,
                                  gt, s.t_tol + (size_t)t * K))
                continue;
            if (cap_for(s.t_alloc + (size_t)t * R, nullptr, d, R) < 1) continue;
            bool off_ok = false;
            for (int o = 0; o < O; ++o) {
                size_t i = (size_t)t * O + o;
                if (!s.off_avail[i]) continue;
                int z = s.off_zone[i], c = s.off_ct[i];
                if (z >= 0 && !s.g_zone_allowed[(size_t)g * Vz + z]) continue;
                if (c >= 0 && !s.g_ct_allowed[(size_t)g * Vc + c]) continue;
                off_ok = true;
                break;
            }
            if (off_ok) F[(size_t)g * T + t] = 1;
        }
    }
}

// ---- template-level overlap for new-bin placement ----
static void build_tmpl_full(const SolveShared& s, std::vector<uint8_t>& tmpl_full) {
    const int G = s.G, K = s.K, W = s.W, M = s.M;
    for (int g = 0; g < G; ++g) {
        const uint32_t* gm = s.g_mask + (size_t)g * K * W;
        const uint8_t* gh = s.g_has + (size_t)g * K;
        for (int m = 0; m < M; ++m) {
            if (!s.g_tmpl_ok[(size_t)g * M + m]) continue;
            if (masks_compatible(gm, gh, s.m_mask + (size_t)m * K * W,
                                 s.m_has + (size_t)m * K, K, W,
                                 s.g_tol + (size_t)g * K, s.m_tol + (size_t)m * K))
                tmpl_full[(size_t)g * M + m] = 1;
        }
    }
}

// ---- grouped greedy pack (the body of the original karpenter_solve) ----
static void pack_bins(const SolveShared& s, const std::vector<uint8_t>& F,
                      const std::vector<uint8_t>& tmpl_full,
                      const int32_t* g_count, const float* e_avail,
                      int32_t* assign, int32_t* assign_e, uint8_t* used,
                      int32_t* tmpl_out) {
    const int G = s.G, T = s.T, K = s.K, W = s.W, R = s.R, M = s.M;
    const int B = s.B, CW = s.CW, C = s.C, A = s.A, E = s.E;
    const uint32_t* g_mask = s.g_mask; const uint8_t* g_has = s.g_has;
    const uint8_t* g_tol = s.g_tol; const float* g_demand = s.g_demand;
    const uint8_t* g_tmpl_ok = s.g_tmpl_ok;
    const int32_t* g_bin_cap = s.g_bin_cap; const uint8_t* g_single = s.g_single;
    const uint32_t* g_decl = s.g_decl; const uint32_t* g_match = s.g_match;
    const int32_t* g_sown = s.g_sown; const uint8_t* g_smatch = s.g_smatch;
    const uint8_t* g_aneed = s.g_aneed; const uint8_t* g_amatch = s.g_amatch;
    const uint8_t* ge_ok = s.ge_ok;
    const int32_t* e_npods = s.e_npods; const int32_t* e_scnt = s.e_scnt;
    const uint32_t* e_decl = s.e_decl; const uint32_t* e_match = s.e_match;
    const int32_t* e_aff = s.e_aff;
    const float* t_alloc = s.t_alloc; const float* t_cap = s.t_cap;
    const int32_t* t_tmpl = s.t_tmpl;
    const uint32_t* m_mask = s.m_mask; const uint8_t* m_has = s.m_has;
    const float* m_overhead = s.m_overhead; const float* m_limits = s.m_limits;
    const int32_t* m_minv = s.m_minv;
    (void)g_tol;
    std::vector<Bin> bins;
    bins.reserve(256);
    std::vector<float> rem((size_t)M * R);
    std::memcpy(rem.data(), m_limits, sizeof(float) * M * R);
    std::memset(assign, 0, sizeof(int32_t) * (size_t)G * B);
    std::memset(used, 0, (size_t)B);
    std::memset(tmpl_out, 0, sizeof(int32_t) * (size_t)B);

    // existing-node state (mirrors ops/kernels.py phase A): fixed capacity,
    // evolving load + topology class state
    std::vector<float> eload((size_t)E * R, 0.0f);
    std::vector<int32_t> enp(e_npods, e_npods + E);
    std::vector<int32_t> escnt(e_scnt, e_scnt + (size_t)E * C);
    std::vector<uint32_t> edecl(e_decl, e_decl + (size_t)E * CW);
    std::vector<uint32_t> ematch(e_match, e_match + (size_t)E * CW);
    std::vector<int32_t> eaff(e_aff, e_aff + (size_t)E * A);
    std::memset(assign_e, 0, sizeof(int32_t) * (size_t)G * E);

    std::vector<int> order;  // bin indices sorted by npods (emptiest first)
    for (int g = 0; g < G; ++g) {
        int n = g_count[g];
        if (n <= 0) continue;
        const uint32_t* gm = g_mask + (size_t)g * K * W;
        const uint8_t* gh = g_has + (size_t)g * K;
        const float* d = g_demand + (size_t)g * R;
        const uint8_t* Fg = F.data() + (size_t)g * T;
        const int cap_g = g_bin_cap[g] > 0 ? g_bin_cap[g] : (1 << 30);
        const bool single = g_single[g] != 0;
        const uint32_t* decl_g = g_decl + (size_t)g * CW;
        const uint32_t* match_g = g_match + (size_t)g * CW;
        const int32_t* sown_g = g_sown + (size_t)g * C;
        const uint8_t* smatch_g = g_smatch + (size_t)g * C;
        const uint8_t* aneed_g = g_aneed + (size_t)g * A;
        const uint8_t* amatch_g = g_amatch + (size_t)g * A;
        bool any_aneed = false;
        for (int a = 0; a < A; ++a) any_aneed = any_aneed || aneed_g[a];
        int cap_own = 1 << 30;  // fresh-bin cap from owned spread classes
        for (int c = 0; c < C; ++c)
            if (sown_g[c] < SPREAD_UNCAPPED && smatch_g[c])
                cap_own = std::min(cap_own, (int)sown_g[c]);

        // phase A: existing nodes first (scheduler.go:250), emptiest-first;
        // single-bin groups bootstrap fresh claims (device parity)
        if (!single && E > 0) {
            std::vector<int> eorder(E);
            for (int i = 0; i < E; ++i) eorder[i] = i;
            std::stable_sort(eorder.begin(), eorder.end(), [&](int a, int b) {
                return enp[a] < enp[b];
            });
            for (int ei : eorder) {
                if (n <= 0) break;
                if (!ge_ok[(size_t)g * E + ei]) continue;
                bool aok = true;
                for (int w = 0; w < CW; ++w)
                    if ((ematch[(size_t)ei * CW + w] & decl_g[w]) ||
                        (edecl[(size_t)ei * CW + w] & match_g[w])) { aok = false; break; }
                for (int a = 0; a < A && aok; ++a)
                    if (aneed_g[a] && eaff[(size_t)ei * A + a] <= 0) aok = false;
                if (!aok) continue;
                int scap = 1 << 30;
                for (int c = 0; c < C; ++c) {
                    if (g_sown[(size_t)g * C + c] >= SPREAD_UNCAPPED) continue;
                    int rem = g_sown[(size_t)g * C + c] - escnt[(size_t)ei * C + c];
                    if (!smatch_g[c]) rem = rem > 0 ? (1 << 30) : 0;
                    scap = std::min(scap, rem > 0 ? rem : 0);
                }
                int q = cap_for(e_avail + (size_t)ei * R, eload.data() + (size_t)ei * R, d, R);
                q = std::min(q, std::min(cap_g, scap));
                if (q <= 0) continue;
                int take = std::min(q, n);
                n -= take;
                assign_e[(size_t)g * E + ei] += take;
                enp[ei] += take;
                for (int r = 0; r < R; ++r) eload[(size_t)ei * R + r] += take * d[r];
                for (int c = 0; c < C; ++c)
                    if (smatch_g[c]) escnt[(size_t)ei * C + c] += take;
                for (int a = 0; a < A; ++a)
                    if (amatch_g[a]) eaff[(size_t)ei * A + a] += take;
                for (int w = 0; w < CW; ++w) {
                    edecl[(size_t)ei * CW + w] |= decl_g[w];
                    ematch[(size_t)ei * CW + w] |= match_g[w];
                }
            }
        }

        // existing bins, emptiest first (scheduler.go:258)
        order.resize(bins.size());
        for (size_t i = 0; i < bins.size(); ++i) order[i] = (int)i;
        std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
            return bins[a].npods < bins[b].npods;
        });
        if (single) {
            // whole group confined to one bin (hostname pod affinity,
            // topologygroup.go:219): pick the single highest-capacity bin
            int best_bi = -1, best_q = 0;
            for (int bi : order) {
                Bin& bin = bins[bi];
                if (!tmpl_full[(size_t)g * M + bin.tmpl]) continue;
                if (!anti_ok(bin, decl_g, match_g, CW)) continue;
                if (!aff_ok(bin, aneed_g, A)) continue;
                if (!masks_compatible(bin.mask.data(), bin.has.data(), gm, gh, K, W))
                    continue;
                int q = 0;
                int minv = m_minv[bin.tmpl];
                std::vector<int> caps;
                for (int t : bin.types) {
                    if (!Fg[t]) continue;
                    int c = cap_for(t_alloc + (size_t)t * R, bin.load.data(), d, R);
                    if (minv > 0) caps.push_back(c);
                    q = std::max(q, c);
                }
                if (minv > 0) q = std::min(q, minv_cap(caps, minv));
                q = std::min(q, spread_cap(bin, sown_g, smatch_g, C));
                if (q > best_q) { best_q = q; best_bi = bi; }
            }
            order.clear();
            if (best_bi >= 0) order.push_back(best_bi);
        }
        for (int bi : order) {
            if (n <= 0) break;
            Bin& bin = bins[bi];
            if (!tmpl_full[(size_t)g * M + bin.tmpl]) continue;
            if (!anti_ok(bin, decl_g, match_g, CW)) continue;
            if (!aff_ok(bin, aneed_g, A)) continue;
            if (!masks_compatible(bin.mask.data(), bin.has.data(), gm, gh, K, W))
                continue;
            // capacity = max over surviving types still feasible for g
            int q = 0;
            int minv = m_minv[bin.tmpl];
            std::vector<int> caps;
            for (int t : bin.types) {
                if (!Fg[t]) continue;
                int c = cap_for(t_alloc + (size_t)t * R, bin.load.data(), d, R);
                if (minv > 0) caps.push_back(c);
                q = std::max(q, c);
            }
            if (minv > 0) q = std::min(q, minv_cap(caps, minv));
            q = std::min(q, cap_g);  // per-bin topology cap (waves)
            q = std::min(q, spread_cap(bin, sown_g, smatch_g, C));
            if (q <= 0) continue;
            int take = std::min(q, n);
            n -= take;
            assign[(size_t)g * B + bi] += take;
            bin.npods += take;
            for (int r = 0; r < R; ++r) bin.load[r] += take * d[r];
            // shrink surviving types: still feasible for g AND still fits load
            std::vector<int> kept;
            kept.reserve(bin.types.size());
            for (int t : bin.types) {
                if (!Fg[t]) continue;
                bool fits = true;
                const float* alloc = t_alloc + (size_t)t * R;
                for (int r = 0; r < R; ++r)
                    if (bin.load[r] > alloc[r] + EPS) { fits = false; break; }
                if (fits) kept.push_back(t);
            }
            bin.types.swap(kept);
            combine_masks(bin.mask, bin.has, gm, gh, K, W);
            // conflict-class commit: the bin now hosts this group's pods
            for (int w = 0; w < CW; ++w) {
                bin.decl[w] |= decl_g[w];
                bin.match[w] |= match_g[w];
            }
            for (int c = 0; c < C; ++c)
                if (smatch_g[c]) bin.scnt[c] += take;
            for (int a = 0; a < A; ++a)
                if (amatch_g[a]) bin.aff[a] += take;
        }

        // new bins from the first (weight-ordered) feasible template.
        // single-bin groups open at most ONE bin, and only when nothing
        // landed on an existing bin (followers join the first pod's claim
        // or fail, topology.py:207 bootstrap)
        bool opened_for_single = false;
        // affinity owners may open a fresh bin only to BOOTSTRAP: every
        // owned class must be self-matched with zero matches anywhere, and
        // the bootstrap opens exactly ONE bin (topology.py:211-221)
        bool aff_new_ok = true;
        if (any_aneed) {
            for (int a = 0; a < A && aff_new_ok; ++a) {
                if (!aneed_g[a]) continue;
                long total = 0;
                for (const Bin& bn : bins) total += bn.aff[a];
                for (int ei = 0; ei < E; ++ei) total += eaff[(size_t)ei * A + a];
                if (total > 0 || !amatch_g[a]) aff_new_ok = false;
            }
        }
        while (n > 0 && (int)bins.size() < B) {
            if (single && (n < g_count[g] || opened_for_single)) break;
            if (any_aneed && (!aff_new_ok || opened_for_single)) break;
            int m_star = -1, per_node = 0;
            for (int m = 0; m < M && m_star < 0; ++m) {
                if (!tmpl_full[(size_t)g * M + m]) continue;
                int best = 0;
                int minv_m = m_minv[m];
                std::vector<int> caps;
                for (int t = 0; t < T; ++t) {
                    if (t_tmpl[t] != m || !Fg[t]) continue;
                    // nodepool limits: worst-case capacity must fit rem
                    bool lim_ok = true;
                    for (int r = 0; r < R; ++r)
                        if (t_cap[(size_t)t * R + r] > rem[(size_t)m * R + r] + EPS) {
                            lim_ok = false; break;
                        }
                    if (!lim_ok) continue;
                    std::vector<float> ovh(m_overhead + (size_t)m * R,
                                           m_overhead + (size_t)m * R + R);
                    int c = cap_for(t_alloc + (size_t)t * R, ovh.data(), d, R);
                    if (minv_m > 0) caps.push_back(c);
                    best = std::max(best, c);
                }
                // a fresh claim must open with >= minv viable types
                if (minv_m > 0) best = std::min(best, minv_cap(caps, minv_m));
                if (best > 0) { m_star = m; per_node = best; }
            }
            if (m_star < 0) break;  // nothing can host this group

            Bin bin;
            bin.tmpl = m_star;
            bin.load.assign(m_overhead + (size_t)m_star * R,
                            m_overhead + (size_t)m_star * R + R);
            bin.mask.assign(m_mask + (size_t)m_star * K * W,
                            m_mask + (size_t)m_star * K * W + (size_t)K * W);
            bin.has.assign(m_has + (size_t)m_star * K, m_has + (size_t)m_star * K + K);
            bin.decl.assign(decl_g, decl_g + CW);
            bin.match.assign(match_g, match_g + CW);
            per_node = std::min(per_node, std::min(cap_g, cap_own));
            int take = std::min(per_node, n);
            bin.npods = take;
            bin.scnt.assign(C, 0);
            for (int c = 0; c < C; ++c)
                if (smatch_g[c]) bin.scnt[c] = take;
            bin.aff.assign(A, 0);
            for (int a = 0; a < A; ++a)
                if (amatch_g[a]) bin.aff[a] = take;
            for (int r = 0; r < R; ++r) bin.load[r] += take * d[r];
            // candidate types: template's, feasible for g, limit-ok, fits load
            std::vector<float> worst(R, 0.0f);
            for (int t = 0; t < T; ++t) {
                if (t_tmpl[t] != m_star || !Fg[t]) continue;
                bool lim_ok = true, fits = true;
                const float* cap = t_cap + (size_t)t * R;
                const float* alloc = t_alloc + (size_t)t * R;
                for (int r = 0; r < R; ++r) {
                    if (cap[r] > rem[(size_t)m_star * R + r] + EPS) lim_ok = false;
                    if (bin.load[r] > alloc[r] + EPS) fits = false;
                }
                if (!lim_ok || !fits) continue;
                bin.types.push_back(t);
                for (int r = 0; r < R; ++r) worst[r] = std::max(worst[r], cap[r]);
            }
            if (bin.types.empty()) break;
            combine_masks(bin.mask, bin.has, gm, gh, K, W);
            // limit accounting: subtract worst-case capacity (subtractMax)
            for (int r = 0; r < R; ++r) rem[(size_t)m_star * R + r] -= worst[r];
            int bi = (int)bins.size();
            bins.push_back(std::move(bin));
            assign[(size_t)g * B + bi] = take;
            n -= take;
            opened_for_single = true;
        }
        // pods still unplaced are implied by count - sum(assign[g]) and
        // re-routed by the decoder, matching the device kernel's contract
    }

    for (size_t i = 0; i < bins.size(); ++i) {
        used[i] = 1;
        tmpl_out[i] = bins[i].tmpl;
    }
}

static SolveShared make_shared_args(
    int G, int T, int K, int W, int R, int M, int O, int B, int Vz, int Vc,
    int CW, int C, int A, int E,
    const uint32_t* g_mask, const uint8_t* g_has, const uint8_t* g_tol,
    const float* g_demand, const uint8_t* g_zone_allowed,
    const uint8_t* g_ct_allowed, const uint8_t* g_tmpl_ok,
    const int32_t* g_bin_cap, const uint8_t* g_single,
    const uint32_t* g_decl, const uint32_t* g_match,
    const int32_t* g_sown, const uint8_t* g_smatch,
    const uint8_t* g_aneed, const uint8_t* g_amatch,
    const uint8_t* ge_ok, const int32_t* e_npods, const int32_t* e_scnt,
    const uint32_t* e_decl, const uint32_t* e_match, const int32_t* e_aff,
    const uint32_t* t_mask, const uint8_t* t_has, const uint8_t* t_tol,
    const float* t_alloc, const float* t_cap, const int32_t* t_tmpl,
    const int32_t* off_zone, const int32_t* off_ct, const uint8_t* off_avail,
    const uint32_t* m_mask, const uint8_t* m_has, const uint8_t* m_tol,
    const float* m_overhead, const float* m_limits, const int32_t* m_minv) {
    SolveShared s;
    s.G = G; s.T = T; s.K = K; s.W = W; s.R = R; s.M = M; s.O = O; s.B = B;
    s.Vz = Vz; s.Vc = Vc; s.CW = CW; s.C = C; s.A = A; s.E = E;
    s.g_mask = g_mask; s.g_has = g_has; s.g_tol = g_tol; s.g_demand = g_demand;
    s.g_zone_allowed = g_zone_allowed; s.g_ct_allowed = g_ct_allowed;
    s.g_tmpl_ok = g_tmpl_ok; s.g_bin_cap = g_bin_cap; s.g_single = g_single;
    s.g_decl = g_decl; s.g_match = g_match; s.g_sown = g_sown;
    s.g_smatch = g_smatch; s.g_aneed = g_aneed; s.g_amatch = g_amatch;
    s.ge_ok = ge_ok; s.e_npods = e_npods; s.e_scnt = e_scnt;
    s.e_decl = e_decl; s.e_match = e_match; s.e_aff = e_aff;
    s.t_mask = t_mask; s.t_has = t_has; s.t_tol = t_tol;
    s.t_alloc = t_alloc; s.t_cap = t_cap; s.t_tmpl = t_tmpl;
    s.off_zone = off_zone; s.off_ct = off_ct; s.off_avail = off_avail;
    s.m_mask = m_mask; s.m_has = m_has; s.m_tol = m_tol;
    s.m_overhead = m_overhead; s.m_limits = m_limits; s.m_minv = m_minv;
    return s;
}

}  // namespace

extern "C" {

// Returns 0 on success. Output arrays: assign [G*B] i32 (zeroed by callee),
// used [B] u8, tmpl_out [B] i32, F_out [G*T] u8.
int karpenter_solve(
    int G, int T, int K, int W, int R, int M, int O, int B, int Vz, int Vc,
    int CW,
    const uint32_t* g_mask, const uint8_t* g_has, const uint8_t* g_tol,
    const float* g_demand,
    const int32_t* g_count, const uint8_t* g_zone_allowed,
    const uint8_t* g_ct_allowed, const uint8_t* g_tmpl_ok,
    const int32_t* g_bin_cap, const uint8_t* g_single,
    const uint32_t* g_decl, const uint32_t* g_match,
    int C, const int32_t* g_sown, const uint8_t* g_smatch,
    int A, const uint8_t* g_aneed, const uint8_t* g_amatch,
    int E, const float* e_avail, const uint8_t* ge_ok,
    const int32_t* e_npods, const int32_t* e_scnt,
    const uint32_t* e_decl, const uint32_t* e_match,
    const int32_t* e_aff,
    const uint32_t* t_mask, const uint8_t* t_has, const uint8_t* t_tol,
    const float* t_alloc,
    const float* t_cap, const int32_t* t_tmpl,
    const int32_t* off_zone, const int32_t* off_ct, const uint8_t* off_avail,
    const uint32_t* m_mask, const uint8_t* m_has, const uint8_t* m_tol,
    const float* m_overhead, const float* m_limits, const int32_t* m_minv,
    int32_t* assign, int32_t* assign_e, uint8_t* used, int32_t* tmpl_out,
    uint8_t* F_out) {
    SolveShared s = make_shared_args(
        G, T, K, W, R, M, O, B, Vz, Vc, CW, C, A, E,
        g_mask, g_has, g_tol, g_demand, g_zone_allowed, g_ct_allowed,
        g_tmpl_ok, g_bin_cap, g_single, g_decl, g_match, g_sown, g_smatch,
        g_aneed, g_amatch, ge_ok, e_npods, e_scnt, e_decl, e_match, e_aff,
        t_mask, t_has, t_tol, t_alloc, t_cap, t_tmpl, off_zone, off_ct,
        off_avail, m_mask, m_has, m_tol, m_overhead, m_limits, m_minv);
    std::vector<uint8_t> F((size_t)G * T, 0);
    build_feasibility(s, F);
    std::memcpy(F_out, F.data(), (size_t)G * T);
    std::vector<uint8_t> tmpl_full((size_t)G * M, 0);
    build_tmpl_full(s, tmpl_full);
    pack_bins(s, F, tmpl_full, g_count, e_avail, assign, assign_e, used,
              tmpl_out);
    return 0;
}

// Batched probe entry (ops/consolidate.py _dispatch_native): N
// counterfactual rows over ONE shared snapshot — feasibility and the
// template overlap build once, then the pack runs per row with that row's
// g_count [N*G] and e_avail [N*E*R]. Outputs are the probe's reductions:
// placed_g [N*G] (fresh-bin + existing placements per group) and
// used_out [N] (fresh claims opened). The per-row full outputs the single
// entry would emit never materialize host-side.
int karpenter_solve_probe_batch(
    int N,
    int G, int T, int K, int W, int R, int M, int O, int B, int Vz, int Vc,
    int CW,
    const uint32_t* g_mask, const uint8_t* g_has, const uint8_t* g_tol,
    const float* g_demand,
    const int32_t* g_count_rows, const uint8_t* g_zone_allowed,
    const uint8_t* g_ct_allowed, const uint8_t* g_tmpl_ok,
    const int32_t* g_bin_cap, const uint8_t* g_single,
    const uint32_t* g_decl, const uint32_t* g_match,
    int C, const int32_t* g_sown, const uint8_t* g_smatch,
    int A, const uint8_t* g_aneed, const uint8_t* g_amatch,
    int E, const float* e_avail_rows, const uint8_t* ge_ok,
    const int32_t* e_npods, const int32_t* e_scnt,
    const uint32_t* e_decl, const uint32_t* e_match,
    const int32_t* e_aff,
    const uint32_t* t_mask, const uint8_t* t_has, const uint8_t* t_tol,
    const float* t_alloc,
    const float* t_cap, const int32_t* t_tmpl,
    const int32_t* off_zone, const int32_t* off_ct, const uint8_t* off_avail,
    const uint32_t* m_mask, const uint8_t* m_has, const uint8_t* m_tol,
    const float* m_overhead, const float* m_limits, const int32_t* m_minv,
    int32_t* placed_g, int32_t* used_out) {
    SolveShared s = make_shared_args(
        G, T, K, W, R, M, O, B, Vz, Vc, CW, C, A, E,
        g_mask, g_has, g_tol, g_demand, g_zone_allowed, g_ct_allowed,
        g_tmpl_ok, g_bin_cap, g_single, g_decl, g_match, g_sown, g_smatch,
        g_aneed, g_amatch, ge_ok, e_npods, e_scnt, e_decl, e_match, e_aff,
        t_mask, t_has, t_tol, t_alloc, t_cap, t_tmpl, off_zone, off_ct,
        off_avail, m_mask, m_has, m_tol, m_overhead, m_limits, m_minv);
    std::vector<uint8_t> F((size_t)G * T, 0);
    build_feasibility(s, F);
    std::vector<uint8_t> tmpl_full((size_t)G * M, 0);
    build_tmpl_full(s, tmpl_full);
    std::vector<int32_t> assign((size_t)G * B);
    std::vector<int32_t> assign_e((size_t)G * E);
    std::vector<uint8_t> used((size_t)B);
    std::vector<int32_t> tmpl_out((size_t)B);
    for (int i = 0; i < N; ++i) {
        pack_bins(s, F, tmpl_full,
                  g_count_rows + (size_t)i * G,
                  e_avail_rows + (size_t)i * E * R,
                  assign.data(), assign_e.data(), used.data(),
                  tmpl_out.data());
        for (int g = 0; g < G; ++g) {
            int64_t total = 0;
            for (int b = 0; b < B; ++b) total += assign[(size_t)g * B + b];
            for (int e = 0; e < E; ++e) total += assign_e[(size_t)g * E + e];
            placed_g[(size_t)i * G + g] = (int32_t)total;
        }
        int32_t u = 0;
        for (int b = 0; b < B; ++b) u += used[b] ? 1 : 0;
        used_out[i] = u;
    }
    return 0;
}

}  // extern "C"
