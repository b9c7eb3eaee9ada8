// Exact EMD via network simplex for the dense transportation problem.
//
// Native runtime component of shwd_tpu (SURVEY.md §2 native-deps table): the
// reference leans on POT's C++ network simplex through ot.emd2
// (Point_Cloud_Resistration/losses/s2_wasserstein.py:40-45) for its exact
// transport distances; this is our own from-scratch implementation of the
// classic primal network simplex for bipartite transportation, exposed with
// a C ABI for ctypes. It backs (1) exact-W2 evaluation in the gradient-flow
// benchmark, (2) oracle parity checks in tests. The TPU training path never
// calls it — that's eps-scaled Sinkhorn / sliced OT on device.
//
// Algorithm (textbook, original implementation):
//   - nodes: n sources (supply a_i) + m sinks (demand b_j)
//   - initial basic feasible solution: northwest-corner rule (spanning tree)
//   - iterate: node potentials from the tree; entering arc by block pricing
//     (most negative reduced cost within a rotating block); leaving arc by
//     min flow on the counter-oriented arcs of the tree cycle; pivot.
//   - anti-cycling: tiny deterministic supply perturbation.
//
// Complexity per pivot: O(n*m / BLOCKS) pricing + O(n+m) tree ops; pivots
// empirically ~O(n+m) for these geometric costs.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Tree {
  int nodes;                       // n + m
  std::vector<int> parent;         // parent node (-1 at root)
  std::vector<double> flow_to_parent;
  std::vector<int> depth;
  // adjacency of basic arcs
  std::vector<std::vector<int>> adj;

  explicit Tree(int total) : nodes(total), parent(total, -1),
                             flow_to_parent(total, 0.0), depth(total, 0),
                             adj(total) {}

  void rebuild_from_adj(const std::vector<std::vector<double>>& flow_of_arc) {
    // re-root at 0 with iterative DFS; flow_of_arc maps (min,max) pair flow
    std::vector<int> stack;
    std::vector<char> seen(nodes, 0);
    parent.assign(nodes, -1);
    depth.assign(nodes, 0);
    stack.push_back(0);
    seen[0] = 1;
    while (!stack.empty()) {
      int u = stack.back();
      stack.pop_back();
      for (int v : adj[u]) {
        if (!seen[v]) {
          seen[v] = 1;
          parent[v] = u;
          depth[v] = depth[u] + 1;
          stack.push_back(v);
        }
      }
    }
    (void)flow_of_arc;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. cost_out <- <P*, C>; if flow_out != nullptr it
// receives the n*m dense optimal plan.
int shwd_emd_exact(int n, int m, const double* a_in, const double* b_in,
                   const double* cost, double* flow_out, double* cost_out,
                   int max_pivots) {
  const int total = n + m;
  std::vector<double> a(a_in, a_in + n), b(b_in, b_in + m);

  // normalize to equal mass and perturb for anti-cycling
  double sa = 0, sb = 0;
  for (double v : a) sa += v;
  for (double v : b) sb += v;
  if (sa <= 0 || sb <= 0) return 1;
  const double scale = sa / sb;
  for (double& v : b) v *= scale;
  const double eps_perturb = 1e-11 * sa / n;
  double extra = 0.0;
  for (int i = 0; i < n; ++i) { a[i] += eps_perturb * (i + 1); extra += eps_perturb * (i + 1); }
  b[m - 1] += extra;

  // --- northwest corner initial solution -------------------------------
  // basic arcs stored as (i, j, flow); at most n + m - 1 of them
  std::vector<int> arc_i, arc_j;
  std::vector<double> arc_flow;
  arc_i.reserve(total); arc_j.reserve(total); arc_flow.reserve(total);
  {
    std::vector<double> ra = a, rb = b;
    int i = 0, j = 0;
    while (i < n && j < m) {
      double f = ra[i] < rb[j] ? ra[i] : rb[j];
      arc_i.push_back(i); arc_j.push_back(j); arc_flow.push_back(f);
      ra[i] -= f; rb[j] -= f;
      // with perturbed supplies exactly one side empties (no double advance)
      if (ra[i] <= rb[j]) { ++i; } else { ++j; }
    }
    // the perturbation guarantees n + m - 1 arcs; pad defensively
    while ((int)arc_i.size() < total - 1) {
      arc_i.push_back(n - 1); arc_j.push_back(m - 1); arc_flow.push_back(0.0);
    }
  }

  Tree tree(total);
  std::vector<double> u(n), v(m);
  std::vector<char> u_set(n), v_set(m);
  // map node -> list of (arc index)
  auto rebuild_adj = [&]() {
    for (auto& lst : tree.adj) lst.clear();
    for (size_t k = 0; k < arc_i.size(); ++k) {
      tree.adj[arc_i[k]].push_back(n + arc_j[k]);
      tree.adj[n + arc_j[k]].push_back(arc_i[k]);
    }
  };

  // arc lookup for tree edges: store flow keyed by (source,sink)
  // use a flat map: idx = i * m + j  -> basic arc index + 1 (0 = nonbasic)
  std::vector<int> basic_of(static_cast<size_t>(n) * m, 0);
  auto refresh_basic_map = [&]() {
    std::fill(basic_of.begin(), basic_of.end(), 0);
    for (size_t k = 0; k < arc_i.size(); ++k)
      basic_of[static_cast<size_t>(arc_i[k]) * m + arc_j[k]] = (int)k + 1;
  };

  rebuild_adj();
  refresh_basic_map();
  std::vector<std::vector<double>> dummy;
  tree.rebuild_from_adj(dummy);

  // potentials: u_i + v_j = C_ij on basic arcs; solve by BFS over tree
  auto compute_potentials = [&]() {
    std::fill(u_set.begin(), u_set.end(), 0);
    std::fill(v_set.begin(), v_set.end(), 0);
    std::vector<int> stack{0};
    u[0] = 0.0; u_set[0] = 1;
    while (!stack.empty()) {
      int node = stack.back(); stack.pop_back();
      for (int nb : tree.adj[node]) {
        if (node < n) {            // node is a source, nb is sink n+j
          int j = nb - n;
          if (!v_set[j]) {
            v[j] = cost[static_cast<size_t>(node) * m + j] - u[node];
            v_set[j] = 1;
            stack.push_back(nb);
          }
        } else {                   // node is sink, nb is source
          int j = node - n;
          if (!u_set[nb]) {
            u[nb] = cost[static_cast<size_t>(nb) * m + j] - v[j];
            u_set[nb] = 1;
            stack.push_back(nb);
          }
        }
      }
    }
  };

  const double tol = 1e-10;
  int block = 0;
  const int n_blocks = 64;
  const long arcs_total = static_cast<long>(n) * m;
  const long block_size = (arcs_total + n_blocks - 1) / n_blocks;

  if (max_pivots <= 0) max_pivots = 50 * total + 10000;

  for (int pivot = 0; pivot < max_pivots; ++pivot) {
    compute_potentials();

    // ---- entering arc: best reduced cost over rotating blocks ----------
    int best_i = -1, best_j = -1;
    double best_r = -tol;
    for (int scanned = 0; scanned < n_blocks && best_i < 0; ++scanned) {
      long lo = block * block_size;
      long hi = lo + block_size < arcs_total ? lo + block_size : arcs_total;
      double local_best = -tol;
      long local_arc = -1;
      for (long t = lo; t < hi; ++t) {
        int i = (int)(t / m), j = (int)(t % m);
        double r = cost[t] - u[i] - v[j];
        if (r < local_best) { local_best = r; local_arc = t; }
      }
      block = (block + 1) % n_blocks;
      if (local_arc >= 0) {
        best_i = (int)(local_arc / m);
        best_j = (int)(local_arc % m);
        best_r = local_best;
      }
    }
    if (best_i < 0) break;         // optimal
    (void)best_r;

    // ---- find cycle: path best_i -> root, path (n+best_j) -> root ------
    int x = best_i, y = n + best_j;
    std::vector<int> path_x{x}, path_y{y};
    while (tree.depth[x] > tree.depth[y]) { x = tree.parent[x]; path_x.push_back(x); }
    while (tree.depth[y] > tree.depth[x]) { y = tree.parent[y]; path_y.push_back(y); }
    while (x != y) {
      x = tree.parent[x]; path_x.push_back(x);
      y = tree.parent[y]; path_y.push_back(y);
    }
    // cycle: best_i .. lca (path_x) then reverse(path_y) .. best_j, closed by
    // the entering arc (best_i, best_j). Orientation: entering arc carries
    // +delta from source best_i to sink best_j; traverse accordingly.
    std::vector<int> cycle;  // node sequence starting at best_i, ending best_j
    cycle.insert(cycle.end(), path_x.begin(), path_x.end());
    for (auto it = path_y.rbegin() + 1; it != path_y.rend(); ++it)
      cycle.push_back(*it);

    // arcs along the cycle alternate source->sink / sink->source; flow on a
    // tree arc (i, j): +delta if traversed sink->source-ish against the
    // entering direction… determine sign per arc: moving delta around the
    // cycle, arcs from source to sink *in traversal order from best_j back
    // to best_i* gain flow alternately. Simpler: walk pairs and compute.
    double delta = std::numeric_limits<double>::infinity();
    int leave_arc = -1;
    std::vector<std::pair<int, int>> minus_arcs;  // (basic idx, sign)
    std::vector<int> arc_idx_seq; std::vector<int> arc_sign_seq;
    for (size_t t = 0; t + 1 < cycle.size(); ++t) {
      int pnode = cycle[t], qnode = cycle[t + 1];
      int si = pnode < n ? pnode : qnode;       // source endpoint
      int sj = pnode < n ? qnode - n : pnode - n;
      int bk = basic_of[static_cast<size_t>(si) * m + sj] - 1;
      // orientation: the entering arc sends flow source(best_i)->sink(best_j);
      // traversing the cycle from best_i to best_j via tree, an arc crossed
      // source->sink is *reduced*, sink->source is *increased*? Derive:
      // cycle direction best_i -> ... -> best_j, then entering arc closes
      // best_j -> best_i (conceptually reversed). Pushing delta through the
      // entering arc increases flow best_i->best_j; conservation then
      // alternates signs along the tree path starting with '-' on the arc
      // incident to best_i if that arc leaves best_i as a source.
      int sign = (pnode < n) ? -1 : +1;  // source->sink traversal: minus
      arc_idx_seq.push_back(bk);
      arc_sign_seq.push_back(sign);
      if (sign < 0 && arc_flow[bk] < delta) {
        delta = arc_flow[bk];
        leave_arc = bk;
      }
    }
    if (leave_arc < 0) return 2;   // should not happen (degenerate guard)

    for (size_t t = 0; t < arc_idx_seq.size(); ++t)
      arc_flow[arc_idx_seq[t]] += arc_sign_seq[t] * delta;

    // pivot: replace leaving arc with entering arc (incremental maps)
    basic_of[static_cast<size_t>(arc_i[leave_arc]) * m + arc_j[leave_arc]] = 0;
    arc_i[leave_arc] = best_i;
    arc_j[leave_arc] = best_j;
    arc_flow[leave_arc] = delta;
    basic_of[static_cast<size_t>(best_i) * m + best_j] = leave_arc + 1;
    rebuild_adj();
    tree.rebuild_from_adj(dummy);
  }

  // ---- emit ------------------------------------------------------------
  double total_cost = 0.0;
  if (flow_out) std::memset(flow_out, 0, sizeof(double) * n * m);
  for (size_t k = 0; k < arc_i.size(); ++k) {
    const size_t idx = static_cast<size_t>(arc_i[k]) * m + arc_j[k];
    total_cost += arc_flow[k] * cost[idx];
    if (flow_out) flow_out[idx] += arc_flow[k];
  }
  *cost_out = total_cost;
  return 0;
}

}  // extern "C"
