// Native CPU kernels for the classical codec oracle.
//
// The reference's hot loops (BCJR recursions commpy/channelcoding/turbo.py:86-166,
// Viterbi ACS convcode.py:438-538) were historically Cython and run as slow
// Python in the mounted tree. These C++ implementations are the production
// host-side oracle; the tests hold them against the numpy oracles of
// turboae_tpu_torch/classical, and the benchmark CLIs' `-engine native`
// decodes with them on the host.
//
// Build: lazily compiled by native/__init__.py:build() (g++ -O3 -march=native
// -shared -fPIC -pthread) into kernels/_build/. Exposed via ctypes.
//
// Conventions: trellis tables are int32 [S x U]; symbols are double.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MAP/BCJR decode (probability domain with per-step normalization, matching
// classical/bcjr.map_decode semantics exactly).
//
// sys, par: [L] received symbols. L_int: [L] prior LLRs.
// next_state: [S*U], out_msg/out_par: [S*U] BPSK-mapped ideal bits (+-1).
// Outputs: L_post [L] full a-posteriori LLRs (reference "L_ext" convention).
// ---------------------------------------------------------------------------
void bcjr_map_decode(const double* sys, const double* par, int L,
                     const int32_t* next_state, const double* out_msg,
                     const double* out_par, int S, int U,
                     double noise_variance, const double* L_int,
                     double* L_post) {
    const double inv2v = 1.0 / (2.0 * noise_variance);

    std::vector<double> prior0(L), prior1(L);
    for (int t = 0; t < L; ++t) {
        prior0[t] = 1.0 / (1.0 + std::exp(L_int[t]));
        prior1[t] = 1.0 - prior0[t];
    }

    // gamma[t][s*U+u]
    std::vector<double> gamma((size_t)L * S * U);
    for (int t = 0; t < L; ++t) {
        for (int s = 0; s < S; ++s) {
            for (int u = 0; u < U; ++u) {
                const double x = sys[t] - out_msg[s * U + u];
                const double y = par[t] - out_par[s * U + u];
                gamma[(size_t)t * S * U + s * U + u] =
                    std::exp(-(x * x + y * y) * inv2v);
            }
        }
    }

    // backward
    std::vector<double> beta((size_t)(L + 1) * S, 0.0);
    for (int s = 0; s < S; ++s) beta[(size_t)L * S + s] = 1.0;
    for (int t = L - 1; t >= 0; --t) {
        double total = 0.0;
        for (int s = 0; s < S; ++s) {
            double acc = 0.0;
            for (int u = 0; u < U; ++u) {
                const int ns = next_state[s * U + u];
                const double pr = (u == 0) ? prior0[t] : prior1[t];
                acc += beta[(size_t)(t + 1) * S + ns] *
                       gamma[(size_t)t * S * U + s * U + u] * pr;
            }
            beta[(size_t)t * S + s] = acc;
            total += acc;
        }
        if (total > 0) {
            for (int s = 0; s < S; ++s) beta[(size_t)t * S + s] /= total;
        }
    }

    // forward + APP
    std::vector<double> alpha(S, 0.0), new_alpha(S);
    alpha[0] = 1.0;
    for (int t = 0; t < L; ++t) {
        double app0 = 0.0, app1 = 0.0;
        std::fill(new_alpha.begin(), new_alpha.end(), 0.0);
        for (int s = 0; s < S; ++s) {
            for (int u = 0; u < U; ++u) {
                const int ns = next_state[s * U + u];
                const double g = gamma[(size_t)t * S * U + s * U + u];
                const double contrib = alpha[s] * g;
                const double pr = (u == 0) ? prior0[t] : prior1[t];
                new_alpha[ns] += contrib * pr;
                const double a = contrib * beta[(size_t)(t + 1) * S + ns];
                if (u == 0) app0 += a; else app1 += a;
            }
        }
        L_post[t] = L_int[t] + std::log(app1 / app0);
        double total = 0.0;
        for (int s = 0; s < S; ++s) total += new_alpha[s];
        if (total > 0) {
            for (int s = 0; s < S; ++s) alpha[s] = new_alpha[s] / total;
        } else {
            std::swap(alpha, new_alpha);
        }
    }
}

// ---------------------------------------------------------------------------
// Full turbo decode (hazzys variant): iterates two MAP decoders with the
// weighted-systematic subtraction (classical/turbo.hazzys_turbo_decode).
// p_array: [L] interleaver permutation. decoded: [L] output bits.
// ---------------------------------------------------------------------------
// variant: 0 = hazzys (classical/turbo.hazzys_turbo_decode), 1 = hazzys_g
// (damped extrinsics, reference turbo.py:433-518).
static void turbo_decode_one(const double* sys, const double* par1,
                             const double* par2, int L,
                             const int32_t* next_state, const double* out_msg,
                             const double* out_par, int S, int U,
                             double noise_variance, int num_iterations,
                             const int32_t* p_array, int variant,
                             int32_t* decoded) {
    std::vector<double> L_int_1(L, 0.0), L_ext_1(L), L_int_2(L), L_ext_2(L);
    std::vector<double> sys_i(L), wsys(L), tmp(L);
    for (int t = 0; t < L; ++t) {
        sys_i[t] = sys[(size_t)p_array[t]];
        wsys[t] = 2.0 * sys[t] / noise_variance;
    }

    for (int it = 0; it < num_iterations; ++it) {
        bcjr_map_decode(sys, par1, L, next_state, out_msg, out_par, S, U,
                        noise_variance, L_int_1.data(), L_ext_1.data());
        for (int t = 0; t < L; ++t)
            L_ext_1[t] = L_ext_1[t] - L_int_1[t] - wsys[t];
        if (variant == 1)
            for (int t = 0; t < L; ++t)
                L_ext_1[t] *= 0.9 * std::exp(-0.01 * std::abs(L_ext_1[t]));
        for (int t = 0; t < L; ++t) L_int_2[t] = L_ext_1[(size_t)p_array[t]];

        bcjr_map_decode(sys_i.data(), par2, L, next_state, out_msg, out_par,
                        S, U, noise_variance, L_int_2.data(), L_ext_2.data());
        for (int t = 0; t < L; ++t) L_ext_2[t] -= L_int_2[t];
        if (variant == 1)
            for (int t = 0; t < L; ++t)
                L_ext_2[t] *= 0.9 * std::exp(-0.01 * std::abs(L_ext_2[t]));
        for (int t = 0; t < L; ++t) tmp[(size_t)p_array[t]] = L_ext_2[t];
        for (int t = 0; t < L; ++t) L_int_1[t] = tmp[t] - wsys[t];
    }

    for (int t = 0; t < L; ++t)
        decoded[t] = (L_ext_1[t] + L_int_1[t] + wsys[t] > 0.0) ? 1 : 0;
}

void turbo_decode_hazzys(const double* sys, const double* par1,
                         const double* par2, int L,
                         const int32_t* next_state, const double* out_msg,
                         const double* out_par, int S, int U,
                         double noise_variance, int num_iterations,
                         const int32_t* p_array, int32_t* decoded) {
    turbo_decode_one(sys, par1, par2, L, next_state, out_msg, out_par, S, U,
                     noise_variance, num_iterations, p_array, 0, decoded);
}

// ---------------------------------------------------------------------------
// Viterbi decode, full traceback (matches classical/convcode.viterbi_decode).
// received: [T*n] symbols; decoding_type: 0=hard, 1=unquantized(euclid),
// 2=tdist3, 3=tdist5. pred_state/pred_input: [S*P] predecessor tables.
// ideal_bits: [S*P*n] predecessor-branch output bits.
// decoded: [T] output bits.
// ---------------------------------------------------------------------------
void viterbi_full(const double* received, int T, int n,
                  const int32_t* pred_state, const int32_t* pred_input,
                  const double* ideal_bits, int S, int P,
                  int decoding_type, int32_t* decoded) {
    const double INF = 1e18;
    std::vector<double> pm(S, INF), new_pm(S);
    pm[0] = 0.0;
    std::vector<int32_t> bp_s((size_t)T * S), bp_u((size_t)T * S);

    for (int t = 0; t < T; ++t) {
        const double* r = received + (size_t)t * n;
        for (int s = 0; s < S; ++s) {
            double best = INF;
            int besti = 0;
            for (int p = 0; p < P; ++p) {
                const int ps = pred_state[s * P + p];
                double bm = 0.0;
                const double* ib = ideal_bits + ((size_t)s * P + p) * n;
                if (decoding_type == 0) {
                    for (int i = 0; i < n; ++i)
                        bm += (double)(((int)r[i]) ^ ((int)ib[i]));
                } else {
                    for (int i = 0; i < n; ++i) {
                        const double d = r[i] - (2.0 * ib[i] - 1.0);
                        if (decoding_type == 1) bm += d * d;
                        else if (decoding_type == 2) bm += std::log1p(d * d);
                        else bm += std::log1p(d * d / 4.0);
                    }
                }
                const double m = pm[ps] + bm;
                if (m < best) { best = m; besti = p; }
            }
            new_pm[s] = best;
            bp_s[(size_t)t * S + s] = pred_state[s * P + besti];
            bp_u[(size_t)t * S + s] = pred_input[s * P + besti];
        }
        std::swap(pm, new_pm);
    }

    int state = 0;  // terminated codes end in state 0
    for (int t = T - 1; t >= 0; --t) {
        decoded[t] = bp_u[(size_t)t * S + state];
        state = bp_s[(size_t)t * S + state];
    }
}

// ---------------------------------------------------------------------------
// Batched turbo decode: B independent blocks fanned out over std::threads
// (blocks are embarrassingly parallel; an atomic counter load-balances).
// ctypes releases the GIL for the call, so Python callers get true
// parallelism. num_threads <= 0 means hardware_concurrency.
// variant: 0 = hazzys, 1 = hazzys_g (damped).
// ---------------------------------------------------------------------------
void turbo_decode_batch_mt(const double* sys, const double* par1,
                           const double* par2, int B, int L,
                           const int32_t* next_state, const double* out_msg,
                           const double* out_par, int S, int U,
                           double noise_variance, int num_iterations,
                           const int32_t* p_array, int variant,
                           int num_threads, int32_t* decoded) {
    if (num_threads <= 0)
        num_threads = (int)std::thread::hardware_concurrency();
    num_threads = std::max(1, std::min(num_threads, B));

    std::atomic<int> next(0);
    auto worker = [&]() {
        for (int b = next.fetch_add(1); b < B; b = next.fetch_add(1)) {
            turbo_decode_one(sys + (size_t)b * L, par1 + (size_t)b * L,
                             par2 + (size_t)b * L, L, next_state, out_msg,
                             out_par, S, U, noise_variance, num_iterations,
                             p_array, variant, decoded + (size_t)b * L);
        }
    };
    if (num_threads == 1) { worker(); return; }
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int i = 0; i < num_threads; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
}

// Back-compat single-threaded hazzys entry point.
void turbo_decode_hazzys_batch(const double* sys, const double* par1,
                               const double* par2, int B, int L,
                               const int32_t* next_state, const double* out_msg,
                               const double* out_par, int S, int U,
                               double noise_variance, int num_iterations,
                               const int32_t* p_array, int32_t* decoded) {
    turbo_decode_batch_mt(sys, par1, par2, B, L, next_state, out_msg, out_par,
                          S, U, noise_variance, num_iterations, p_array, 0, 1,
                          decoded);
}

}  // extern "C"
