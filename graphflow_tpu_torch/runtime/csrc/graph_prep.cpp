// Native host-side graph preparation for graphflow_tpu_torch (the port's
// own copy of graphflow_tpu/runtime/graph_prep.cpp).
//
// The reference's per-example graph construction (SMP_omega.h:358-582:
// Floyd-Warshall, Weisfeiler-Lehman histograms, exchange-sort vertex
// ranking, receptive-field construction with capping, permutation/pos
// index maps, reduced adjacency) as a standalone shared library called
// from the input pipeline, emitting the static-shaped index arrays the
// models consume.
//
// Every field is bit-identical to the NumPy path of
// graphflow_tpu_torch/core/prep.py; tests/test_torch_native_prep.py holds
// the two (and the JAX package's native path) against each other.  Beside
// the JAX package's outputs it can hand back the shortest paths it already
// computes (``sp_out``), which the NumPy path would compute again.
//
// Build: runtime/native.py compiles it at first use with
//   g++ -O3 -std=c++17 -fPIC -Wall -shared
// into build/native/libgraphprep.so beside the package.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

const long long INF = 1000000000LL;  // reference GCN_1D.h:26

// Exchange sort replicating the reference's non-stable rank_vertices
// (SMP_omega.h:418-434): for i < j, swap when key[order[i]] <lex key[order[j]].
void rank_vertices(const std::vector<std::vector<double>>& hist, int n,
                   std::vector<int>& order, std::vector<int>& rank) {
  order.resize(n);
  rank.resize(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      if (hist[order[i]] < hist[order[j]]) std::swap(order[i], order[j]);
    }
  }
  for (int i = 0; i < n; ++i) rank[order[i]] = i;
}

}  // namespace

extern "C" {

// All output buffers must be pre-allocated and zero/sentinel-initialized by
// the caller:
//   wl_feat [V, F*(nDepth+1)]  zeros
//   sizes   [(L+1), V]         zeros
//   nbr     [L, V, P]          zeros
//   pos     [L, V, P, P]       filled with P (the sentinel)
//   radj    [L, V, P, P]       zeros
//   smask   [(L+1), V, P, P]   zeros
//   sp_out  [V, V]             filled with INF, or null (not written)
// Returns 0 on success, negative on error.
int gf_prepare_graph(
    const int32_t* adj, const double* feature, const double* coulomb,
    int n, int V, int F, int nLevels, int P, int use_cap, int nDepth,
    int has_wl_ordering, int use_coulomb, int use_wl_features,
    double* wl_feat, int32_t* sizes, int32_t* nbr, int32_t* pos,
    double* radj, double* smask, int64_t* sp_out) {
  if (n > V || n <= 0) return -1;
  const int L = nLevels;

  // ---- Floyd-Warshall (SMP_omega.h:358-380) ----
  std::vector<long long> sp((size_t)n * n, INF);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (i == j) sp[(size_t)i * n + j] = 0;
      else if (adj[(size_t)i * V + j] > 0 || adj[(size_t)j * V + i] > 0)
        sp[(size_t)i * n + j] = 1;
    }
  }
  for (int k = 0; k < n; ++k)
    for (int i = 0; i < n; ++i) {
      const long long sik = sp[(size_t)i * n + k];
      if (sik >= INF) continue;
      for (int j = 0; j < n; ++j) {
        const long long alt = sik + sp[(size_t)k * n + j];
        if (alt < sp[(size_t)i * n + j]) sp[(size_t)i * n + j] = alt;
      }
    }
  if (sp_out)
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        sp_out[(size_t)i * V + j] = sp[(size_t)i * n + j];

  // ---- WL histograms (SMP_omega.h:382-404) ----
  const int FD = F * (nDepth + 1);
  std::vector<std::vector<double>> hist(n, std::vector<double>(FD, 0.0));
  for (int v = 0; v < n; ++v)
    for (int u = 0; u < n; ++u) {
      const long long d = sp[(size_t)u * n + v];
      if (d <= nDepth)
        for (int f = 0; f < F; ++f)
          hist[v][(int)d * F + f] += feature[(size_t)u * F + f];
    }

  const int out_fd = use_wl_features ? FD : F;
  for (int v = 0; v < n; ++v)
    for (int f = 0; f < out_fd; ++f)
      wl_feat[(size_t)v * out_fd + f] =
          use_wl_features ? hist[v][f] : feature[(size_t)v * F + f];

  // ---- Ranking ----
  std::vector<int> order, rank;
  rank_vertices(hist, n, order, rank);

  // ---- Receptive fields (SMP_omega.h:509-538) ----
  std::vector<std::vector<std::vector<int>>> phi(L + 1);
  phi[0].resize(n);
  for (int v = 0; v < n; ++v) phi[0][v] = {v};
  for (int l = 1; l <= L; ++l) {
    phi[l].resize(n);
    for (int v = 0; v < n; ++v) {
      std::vector<int>& acc = phi[l][v];
      std::vector<char> seen(n, 0);
      for (int u = 0; u < n; ++u) {
        if (sp[(size_t)u * n + v] <= 1) {
          for (int w : phi[l - 1][u]) {
            if (!seen[w]) { seen[w] = 1; acc.push_back(w); }
          }
        }
      }
      if (use_cap && (int)acc.size() > P) {
        // limit_receptive_field (SMP_omega.h:476-507): sort by
        // (distance, rank), drop whole trailing distance groups.
        if (has_wl_ordering) {
          std::sort(acc.begin(), acc.end(), [&](int a, int b) {
            const long long da = sp[(size_t)v * n + a];
            const long long db = sp[(size_t)v * n + b];
            if (da != db) return da < db;
            return rank[a] < rank[b];
          });
        } else {
          // No-WL models (SMP_omega_pairgraphs.h:468-493) sort by
          // distance ONLY with the reference's exchange sort, which is
          // NOT stable for tied keys — replicate the exact swap sequence
          // for bit parity.
          for (size_t i = 0; i < acc.size(); ++i)
            for (size_t j = i + 1; j < acc.size(); ++j)
              if (sp[(size_t)v * n + acc[i]] > sp[(size_t)v * n + acc[j]])
                std::swap(acc[i], acc[j]);
        }
        while ((int)acc.size() > P) {
          const long long d = sp[(size_t)v * n + acc.back()];
          while (!acc.empty() && sp[(size_t)v * n + acc.back()] == d)
            acc.pop_back();
        }
      }
      if (has_wl_ordering)
        std::sort(acc.begin(), acc.end(),
                  [&](int a, int b) { return rank[a] < rank[b]; });
      if ((int)acc.size() > P) return -2;
    }
  }

  // ---- sizes + smask ----
  for (int l = 0; l <= L; ++l)
    for (int v = 0; v < n; ++v) {
      const int s = (int)phi[l][v].size();
      sizes[(size_t)l * V + v] = s;
      double* sm = smask + (((size_t)l * V + v) * P) * P;
      for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) sm[(size_t)i * P + j] = 1.0;
    }

  // ---- nbr / pos / reduced adjacency (SMP_omega.h:540-581) ----
  std::vector<int> lookup(n);
  for (int l = 1; l <= L; ++l) {
    for (int v = 0; v < n; ++v) {
      const std::vector<int>& phiv = phi[l][v];
      const int s = (int)phiv.size();
      int32_t* nb = nbr + ((size_t)(l - 1) * V + v) * P;
      for (int i = 0; i < s; ++i) {
        const int w = phiv[i];
        nb[i] = w;
        std::fill(lookup.begin(), lookup.end(), P);
        const std::vector<int>& phw = phi[l - 1][w];
        for (int q = 0; q < (int)phw.size(); ++q) lookup[phw[q]] = q;
        int32_t* ps = pos + (((size_t)(l - 1) * V + v) * P + i) * P;
        for (int p = 0; p < s; ++p) ps[p] = lookup[phiv[p]];
      }
      double* ra = radj + (((size_t)(l - 1) * V + v) * P) * P;
      for (int i = 0; i < s; ++i) {
        const int v1 = phiv[i];
        for (int j = 0; j < s; ++j) {
          const int v2 = phiv[j];
          if (use_coulomb) ra[(size_t)i * P + j] = coulomb[(size_t)v1 * V + v2];
          else if (v1 == v2) ra[(size_t)i * P + j] = 1.0;
          else ra[(size_t)i * P + j] = (double)adj[(size_t)v1 * V + v2];
        }
      }
    }
  }
  return 0;
}

// Batched variant: processes nGraphs graphs laid out contiguously
// (``sp_out`` null, or [nGraphs, V, V]).
int gf_prepare_graphs_batch(
    const int32_t* adj, const double* feature, const double* coulomb,
    const int32_t* n_per_graph, int nGraphs,
    int V, int F, int nLevels, int P, int use_cap, int nDepth,
    int has_wl_ordering, int use_coulomb, int use_wl_features,
    double* wl_feat, int32_t* sizes, int32_t* nbr, int32_t* pos,
    double* radj, double* smask, int64_t* sp_out) {
  const int L = nLevels;
  const int out_fd = use_wl_features ? F * (nDepth + 1) : F;
  const size_t adj_s = (size_t)V * V, feat_s = (size_t)V * F;
  const size_t wl_s = (size_t)V * out_fd;
  const size_t sizes_s = (size_t)(L + 1) * V;
  const size_t nbr_s = (size_t)L * V * P;
  const size_t pos_s = (size_t)L * V * P * P;
  const size_t radj_s = pos_s;
  const size_t smask_s = (size_t)(L + 1) * V * P * P;
  for (int g = 0; g < nGraphs; ++g) {
    int rc = gf_prepare_graph(
        adj + g * adj_s, feature + g * feat_s, coulomb + g * adj_s,
        n_per_graph[g], V, F, nLevels, P, use_cap, nDepth, has_wl_ordering,
        use_coulomb, use_wl_features,
        wl_feat + g * wl_s, sizes + g * sizes_s, nbr + g * nbr_s,
        pos + g * pos_s, radj + g * radj_s, smask + g * smask_s,
        sp_out ? sp_out + g * adj_s : nullptr);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
