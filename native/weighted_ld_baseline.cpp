// weighted_ld_baseline — native CPU comparison baseline for weightedld.
//
// A from-scratch C++17 reimplementation of the reference's fast path
// (rust/weighted_ld: site-major storage lib.rs:158-197, fused 4-accumulator
// pair kernel lib.rs:461-486, tiled triangular parallel driver
// lib.rs:589-679) used to anchor the device engine's speedup factor.  Built
// with -O3 -march=native so the inner loop autovectorizes (the analog of
// the reference's packed_simd feature, lib.rs:410-453); parallelized with
// OpenMP work-sharing over triangle tiles (the analog of rayon).
//
// Semantics: Rust-reference variant — per-site major/dominant-minor from
// GLOBAL histograms (not per-pair recomputation), Henikoff per-site
// distinct-count formula, r2 > threshold output filter.  See SURVEY.md
// §2.4 for the catalog of Python/Rust divergences.
//
// Usage:
//   weighted_ld_baseline --fasta-input x.fasta --pair-output out.tsv
//       [--min-acgt 0.8] [--min-variability 0.02] [--max-minor 0.5]
//       [--r2-threshold 0.1] [--unweighted] [--threads N]
//   weighted_ld_baseline --bench N_SEQS N_SITES   # synthetic pairs/s JSON

#include <algorithm>
#include <atomic>
#include <cassert>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <random>
#include <sstream>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint8_t SYM_A = 0, SYM_C = 1, SYM_G = 2, SYM_T = 3, SYM_GAP = 4,
                  SYM_UNK = 5;
constexpr int N_ALLELES = 5;

uint8_t encode_char(char c) {
  switch (c) {
    case 'a': case 'A': return SYM_A;
    case 'c': case 'C': return SYM_C;
    case 'g': case 'G': return SYM_G;
    case 't': case 'T': return SYM_T;
    case '-': return SYM_GAP;
    default: return SYM_UNK;
  }
}

// Site-major alignment store (the SiteSet layout).
struct SiteSet {
  int64_t n_seqs = 0;
  int64_t n_sites = 0;
  std::vector<uint8_t> data;           // [n_sites][n_seqs]
  std::vector<int64_t> site_map;       // original site indices

  const uint8_t* site(int64_t s) const { return data.data() + s * n_seqs; }
};

struct Histogram {
  int64_t count[6] = {0, 0, 0, 0, 0, 0};

  int64_t acgt() const { return count[0] + count[1] + count[2] + count[3]; }
  int64_t acgtm() const { return acgt() + count[4]; }
  int distinct_known() const {
    int d = 0;
    for (int s = 0; s < N_ALLELES; ++s) d += count[s] > 0;
    return d;
  }
  // Major + dominant minor among codes 0..4; strictly-greater updates keep
  // the smaller code on ties.
  void major_minor(uint8_t& maj, uint8_t& dmin) const {
    int64_t best = -1, second = -1;
    int bi = 0, si = 0;
    for (int s = 0; s < N_ALLELES; ++s)
      if (count[s] > best) { best = count[s]; bi = s; }
    for (int s = 0; s < N_ALLELES; ++s)
      if (s != bi && count[s] > second) { second = count[s]; si = s; }
    maj = static_cast<uint8_t>(bi);
    dmin = static_cast<uint8_t>(si);
  }
};

Histogram histogram_of(const uint8_t* col, int64_t n) {
  Histogram h;
  for (int64_t i = 0; i < n; ++i) h.count[col[i]]++;
  return h;
}

// ---------------------------------------------------------------------------
// FASTA ingestion (multi-line records)
// ---------------------------------------------------------------------------

bool read_fasta(const std::string& path, std::vector<std::string>& seqs) {
  std::ifstream in(path);
  if (!in) return false;
  std::string line, cur;
  bool have = false;
  while (std::getline(in, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line.empty()) continue;
    if (line[0] == '>') {
      if (have) seqs.push_back(cur);
      cur.clear();
      have = true;
    } else if (have) {
      cur += line;
    }
  }
  if (have) seqs.push_back(cur);
  return !seqs.empty();
}

SiteSet build_siteset(const std::vector<std::string>& seqs) {
  SiteSet ss;
  ss.n_seqs = static_cast<int64_t>(seqs.size());
  ss.n_sites = static_cast<int64_t>(seqs[0].size());
  for (const auto& s : seqs)
    if (static_cast<int64_t>(s.size()) != ss.n_sites) {
      std::cerr << "ragged alignment\n";
      std::exit(1);
    }
  ss.data.resize(ss.n_sites * ss.n_seqs);
  ss.site_map.resize(ss.n_sites);
  for (int64_t j = 0; j < ss.n_sites; ++j) {
    ss.site_map[j] = j;
    uint8_t* col = ss.data.data() + j * ss.n_seqs;
    for (int64_t i = 0; i < ss.n_seqs; ++i) col[i] = encode_char(seqs[i][j]);
  }
  return ss;
}

SiteSet filter_sites(const SiteSet& in, double min_acgt, double min_minor,
                     double max_minor) {
  SiteSet out;
  out.n_seqs = in.n_seqs;
  int64_t min_acgt_count =
      static_cast<int64_t>(std::ceil(min_acgt * double(in.n_seqs)));
  for (int64_t j = 0; j < in.n_sites; ++j) {
    Histogram h = histogram_of(in.site(j), in.n_seqs);
    if (h.acgt() <= min_acgt_count) continue;
    uint8_t maj, dmin;
    h.major_minor(maj, dmin);
    double frac = 0.0;
    int64_t mc = h.count[dmin], Mc = h.count[maj];
    if (mc > 0) frac = double(mc) / double(mc + Mc);
    if (frac < min_minor || frac > max_minor) continue;
    out.data.insert(out.data.end(), in.site(j), in.site(j) + in.n_seqs);
    out.site_map.push_back(in.site_map[j]);
  }
  out.n_sites = static_cast<int64_t>(out.site_map.size());
  return out;
}

// Henikoff weights, per-site distinct-count formula (Rust variant,
// lib.rs:340-380).
std::vector<float> henikoff_weights(const SiteSet& ss) {
  std::vector<double> acc(ss.n_seqs, 0.0);
  for (int64_t j = 0; j < ss.n_sites; ++j) {
    const uint8_t* col = ss.site(j);
    Histogram h = histogram_of(col, ss.n_seqs);
    int distinct = h.distinct_known();
    if (distinct == 0) continue;
    double contrib[6];
    double total = 0.0;
    for (int s = 0; s < N_ALLELES; ++s) {
      contrib[s] = h.count[s] ? 1.0 / (double(distinct) * double(h.count[s]))
                              : 0.0;
      total += h.count[s] * contrib[s];
    }
    contrib[SYM_UNK] = total / double(distinct);
    for (int64_t i = 0; i < ss.n_seqs; ++i) acc[i] += contrib[col[i]];
  }
  double mx = 0.0;
  for (double v : acc) mx = std::max(mx, v);
  std::vector<float> w(ss.n_seqs);
  for (int64_t i = 0; i < ss.n_seqs; ++i)
    w[i] = static_cast<float>(mx > 0 ? acc[i] / mx : 1.0);
  return w;
}

// ---------------------------------------------------------------------------
// Pair kernel: fused 4-accumulator single pass (lib.rs:461-486 semantics),
// written branchless so -O3 -march=native vectorizes the loop.
// ---------------------------------------------------------------------------

struct LdStats {
  float d, d_prime, r2;
  bool ok;
};

LdStats pair_ld(const uint8_t* __restrict a, const uint8_t* __restrict b,
                const float* __restrict w, int64_t n, uint8_t maj_a,
                uint8_t dmin_a, uint8_t maj_b, uint8_t dmin_b) {
  float tw = 0.f, pa = 0.f, pb = 0.f, mm = 0.f;
#pragma omp simd reduction(+ : tw, pa, pb, mm)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t ca = a[i], cb = b[i];
    const uint8_t am = ca == maj_a, ad = ca == dmin_a;
    const uint8_t bm = cb == maj_b, bd = cb == dmin_b;
    const float keep = static_cast<float>((am | ad) & (bm | bd));
    const float wi = w[i] * keep;
    tw += wi;
    pa += wi * am;
    pb += wi * bm;
    mm += wi * (am & bm);
  }
  LdStats out{0.f, 0.f, 0.f, false};
  if (tw <= 0.f) return out;
  const float inv = 1.0f / tw;
  const float PA = pa * inv, PB = pb * inv;
  const float Pa = 1.0f - PA, Pb = 1.0f - PB;
  const float obs_mm = mm * inv;
  const float obs_md = PA - obs_mm;        // maj_a & dmin_b
  const float obs_dm = PB - obs_mm;        // dmin_a & maj_b
  const float obs_dd = 1.0f - obs_mm - obs_md - obs_dm;
  const float D = PA * PB - obs_mm;
  float denom;
  if (D < 0) {
    denom = std::max(-obs_dd, -obs_mm);
    if (denom == 0) denom = std::min(-obs_dd, -obs_mm);
  } else {
    denom = std::min(obs_dm, obs_md);
    if (denom == 0) denom = std::max(obs_dm, obs_md);
  }
  out.d = D;
  out.d_prime = denom != 0 ? D / denom : 0.f;
  const float var = PA * Pa * PB * Pb;
  out.r2 = var > 0 ? D * D / var : 0.f;
  out.ok = true;
  return out;
}

struct PairRecord {
  int64_t a, b;
  float d, dp, r2;
};

// Tiled upper-triangle driver: OpenMP dynamic scheduling over square tiles
// (chunk locality rationale as lib.rs:589-611).
int64_t all_pairs(const SiteSet& ss, const std::vector<float>& w,
                  double r2_threshold, std::vector<PairRecord>* out,
                  double* seconds) {
  const int64_t S = ss.n_sites, N = ss.n_seqs;
  const int64_t TILE = 64;
  const int64_t G = (S + TILE - 1) / TILE;
  const int64_t n_tiles = G * (G + 1) / 2;

  std::vector<uint8_t> maj(S), dmin(S);
  std::vector<char> variable(S);
  for (int64_t j = 0; j < S; ++j) {
    Histogram h = histogram_of(ss.site(j), N);
    h.major_minor(maj[j], dmin[j]);
    variable[j] = h.distinct_known() >= 2;
  }

  std::atomic<int64_t> n_pairs{0};
  auto t0 = std::chrono::steady_clock::now();

#pragma omp parallel
  {
    std::vector<PairRecord> local;
#pragma omp for schedule(dynamic, 1)
    for (int64_t t = 0; t < n_tiles; ++t) {
      // Linear index -> (row, col) in the tile triangle (triangular root).
      int64_t r = static_cast<int64_t>((std::sqrt(8.0 * double(t) + 1.0) - 1.0) / 2.0);
      while ((r + 1) * (r + 2) / 2 <= t) ++r;
      while (r * (r + 1) / 2 > t) --r;
      const int64_t c = t - r * (r + 1) / 2;
      // r = tile column offset from diagonal; enumerate (row=c, col=c+? )
      const int64_t tj = r, tii = c;  // tii <= tj
      const int64_t a_lo = tii * TILE, a_hi = std::min(a_lo + TILE, S);
      const int64_t b_lo = tj * TILE, b_hi = std::min(b_lo + TILE, S);
      int64_t local_pairs = 0;
      for (int64_t a = a_lo; a < a_hi; ++a) {
        if (!variable[a]) continue;
        const int64_t b_start = std::max(b_lo, a + 1);
        for (int64_t b = b_start; b < b_hi; ++b) {
          if (!variable[b]) continue;
          LdStats st = pair_ld(ss.site(a), ss.site(b), w.data(), N, maj[a],
                               dmin[a], maj[b], dmin[b]);
          ++local_pairs;
          if (st.ok && st.r2 > r2_threshold && out != nullptr) {
            local.push_back({ss.site_map[a], ss.site_map[b], st.d, st.d_prime,
                             st.r2});
          }
        }
      }
      n_pairs += local_pairs;
    }
#pragma omp critical
    if (out != nullptr)
      out->insert(out->end(), local.begin(), local.end());
  }

  auto t1 = std::chrono::steady_clock::now();
  *seconds = std::chrono::duration<double>(t1 - t0).count();
  return n_pairs.load();
}

}  // namespace

int main(int argc, char** argv) {
  std::string fasta, pair_out;
  double min_acgt = 0.8, min_var = 0.02, max_minor = 0.5, r2_thr = 0.1;
  bool unweighted = false;
  int64_t bench_n = 0, bench_s = 0;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) {  // flag given as the last argument
        std::fprintf(stderr, "error: %s needs a value\n", a.c_str());
        std::exit(2);
      }
      return std::string(argv[++i]);
    };
    try {
    if (a == "--fasta-input") fasta = next();
    else if (a == "--pair-output") pair_out = next();
    else if (a == "--min-acgt") min_acgt = std::stod(next());
    else if (a == "--min-variability") min_var = std::stod(next());
    else if (a == "--max-minor") max_minor = std::stod(next());
    else if (a == "--r2-threshold") r2_thr = std::stod(next());
    else if (a == "--unweighted") unweighted = true;
    else if (a == "--threads") {
#ifdef _OPENMP
      omp_set_num_threads(std::stoi(next()));
#else
      next();
#endif
    } else if (a == "--bench") {
      bench_n = std::stoll(next());
      bench_s = std::stoll(next());
    } else {
      std::cerr << "unknown flag " << a << "\n";
      return 2;
    }
    } catch (const std::exception&) {  // std::stod/stoi/stoll on bad input
      std::fprintf(stderr, "error: %s got a malformed numeric value\n",
                   a.c_str());
      return 2;
    }
  }

  SiteSet ss;
  if (bench_n > 0) {
    // Synthetic benchmark input: 60% major allele, 10% missing (the
    // reference criterion bench generator's parameters,
    // benches/bench_weighted_pair_ld.rs:8-28).
    std::mt19937_64 rng(42);
    std::uniform_real_distribution<double> u(0.0, 1.0);
    ss.n_seqs = bench_n;
    ss.n_sites = bench_s;
    ss.data.resize(bench_n * bench_s);
    ss.site_map.resize(bench_s);
    for (int64_t j = 0; j < bench_s; ++j) {
      ss.site_map[j] = j;
      uint8_t* col = ss.data.data() + j * bench_n;
      for (int64_t i = 0; i < bench_n; ++i) {
        double r = u(rng);
        col[i] = r < 0.6 ? SYM_A : (r < 0.9 ? SYM_T : SYM_GAP);
      }
    }
  } else {
    if (fasta.empty()) {
      std::cerr << "need --fasta-input or --bench\n";
      return 2;
    }
    std::vector<std::string> seqs;
    if (!read_fasta(fasta, seqs)) {
      std::cerr << "failed to read " << fasta << "\n";
      return 1;
    }
    SiteSet full = build_siteset(seqs);
    ss = filter_sites(full, min_acgt, min_var, max_minor);
  }

  std::vector<float> w = unweighted
                             ? std::vector<float>(ss.n_seqs, 1.0f)
                             : henikoff_weights(ss);

  std::vector<PairRecord> records;
  double secs = 0.0;
  const bool want_records = bench_n == 0;
  int64_t n_pairs =
      all_pairs(ss, w, r2_thr, want_records ? &records : nullptr, &secs);

  if (bench_n > 0) {
    int threads = 1;
#ifdef _OPENMP
    threads = omp_get_max_threads();
#endif
    std::printf(
        "{\"metric\": \"cpu_baseline_pairs_per_s\", \"n_seqs\": %lld, "
        "\"n_sites\": %lld, \"n_pairs\": %lld, \"seconds\": %.4f, "
        "\"pairs_per_s\": %.0f, \"threads\": %d}\n",
        static_cast<long long>(bench_n), static_cast<long long>(bench_s),
        static_cast<long long>(n_pairs), secs, double(n_pairs) / secs,
        threads);
    return 0;
  }

  std::sort(records.begin(), records.end(),
            [](const PairRecord& x, const PairRecord& y) {
              return x.a != y.a ? x.a < y.a : x.b < y.b;
            });
  FILE* f = pair_out.empty() ? stdout : std::fopen(pair_out.c_str(), "w");
  if (!f) {
    std::cerr << "cannot open " << pair_out << "\n";
    return 1;
  }
  std::fprintf(f, "posa\tposb\tD\tD'\tR2\n");
  for (const auto& r : records)
    std::fprintf(f, "%lld\t%lld\t%.3f\t%.3f\t%.3f\n",
                 static_cast<long long>(r.a), static_cast<long long>(r.b),
                 r.d, r.dp, r.r2);
  if (f != stdout) std::fclose(f);
  std::fprintf(stderr, "%lld pairs in %.3fs (%.0f pairs/s)\n",
               static_cast<long long>(n_pairs), secs,
               double(n_pairs) / secs);
  return 0;
}
