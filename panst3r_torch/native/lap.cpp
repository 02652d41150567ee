// Exact rectangular linear assignment (shortest augmenting path with
// dual potentials — the Jonker-Volgenant family), replacing the host-side
// scipy `linear_sum_assignment` dependency (the reference matches DETR
// queries with scipy's C++ solver, src/panst3r/criterion/matcher.py:188).
//
// Solves min-cost assignment for an (nr x nc) dense cost matrix with
// nr <= nc: every row is assigned a distinct column.  O(nr^2 * nc).
// The Python wrapper transposes taller-than-wide inputs.
//
// Build: g++ -O3 -shared -fPIC lap.cpp -o liblap.so
// (panst3r_torch/native/__init__.py builds it at first use).

#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// One augmenting path from free row `i0`, Dijkstra over reduced costs.
// Returns the sink column (or -1 if infeasible) and the path minimum.
int64_t augmenting_path(int64_t nc, const double* cost, int64_t nr_stride,
                        std::vector<double>& u, std::vector<double>& v,
                        std::vector<int64_t>& path,
                        const std::vector<int64_t>& row4col,
                        std::vector<double>& shortest,
                        std::vector<bool>& SR, std::vector<bool>& SC,
                        std::vector<int64_t>& remaining, int64_t i0,
                        double* p_min_val) {
  double min_val = 0.0;
  int64_t num_remaining = nc;
  for (int64_t it = 0; it < nc; ++it) remaining[it] = nc - 1 - it;
  std::fill(SR.begin(), SR.end(), false);
  std::fill(SC.begin(), SC.end(), false);
  std::fill(shortest.begin(), shortest.end(), kInf);

  int64_t sink = -1;
  int64_t i = i0;
  while (sink == -1) {
    int64_t index = -1;
    double lowest = kInf;
    SR[i] = true;
    for (int64_t it = 0; it < num_remaining; ++it) {
      const int64_t j = remaining[it];
      const double r = min_val + cost[i * nr_stride + j] - u[i] - v[j];
      if (r < shortest[j]) {
        path[j] = i;
        shortest[j] = r;
      }
      if (shortest[j] < lowest ||
          (shortest[j] == lowest && row4col[j] == -1)) {
        lowest = shortest[j];
        index = it;
      }
    }
    min_val = lowest;
    if (min_val == kInf) return -1;  // infeasible
    const int64_t j = remaining[index];
    if (row4col[j] == -1) {
      sink = j;
    } else {
      i = row4col[j];
    }
    SC[j] = true;
    remaining[index] = remaining[--num_remaining];
  }
  *p_min_val = min_val;
  return sink;
}

}  // namespace

extern "C" {

// cost: row-major (nr, nc), nr <= nc.  Outputs: col4row (nr) — the column
// assigned to each row.  Returns 0 on success, -1 if infeasible (inf rows).
int solve_lap(const double* cost, int64_t nr, int64_t nc,
              int64_t* col4row_out) {
  std::vector<double> u(nr, 0.0), v(nc, 0.0), shortest(nc);
  std::vector<int64_t> path(nc, -1), remaining(nc);
  std::vector<int64_t> col4row(nr, -1), row4col(nc, -1);
  std::vector<bool> SR(nr), SC(nc);

  for (int64_t cur_row = 0; cur_row < nr; ++cur_row) {
    double min_val = 0.0;
    const int64_t sink =
        augmenting_path(nc, cost, nc, u, v, path, row4col, shortest, SR, SC,
                        remaining, cur_row, &min_val);
    if (sink < 0) return -1;

    u[cur_row] += min_val;
    for (int64_t i = 0; i < nr; ++i) {
      if (SR[i] && i != cur_row) u[i] += min_val - shortest[col4row[i]];
    }
    for (int64_t j = 0; j < nc; ++j) {
      if (SC[j]) v[j] -= min_val - shortest[j];
    }

    int64_t j = sink;
    while (true) {
      const int64_t i = path[j];
      row4col[j] = i;
      const int64_t tmp = col4row[i];
      col4row[i] = j;
      if (i == cur_row) break;
      j = tmp;
    }
  }
  for (int64_t i = 0; i < nr; ++i) col4row_out[i] = col4row[i];
  return 0;
}

}  // extern "C"
