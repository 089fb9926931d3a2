// Native crystal-graph builder: periodic neighbor search, directed->
// undirected edge pairing, and line-graph (angle) enumeration in one call.
//
// Counterpart of upstream CHGNet's C extension (create_graph.c), which
// only does the edge pairing and leaves neighbor search to pymatgen.
// This builder also owns the neighbor search (uniform-grid cell list over
// periodic images), and reproduces the canonical edge ordering of the
// numpy builder (chgnet_tpu_torch/graph/neighbors.py + builder.py)
// bit-for-bit:
//
//   * directed edges sorted by (center, neighbor, image_a, image_b, image_c)
//   * undirected ids numbered by first appearance in the directed scan
//   * angle rows: for each undirected bond with d <= bond_cutoff, both of
//     its directed members (center c) pair with every directed edge from c
//     with d < bond_cutoff, in ascending directed index order, excluding
//     the member edge itself.
//
// Exposed via a plain C ABI for ctypes (graph/fast/fast_graph.py), built
// by utils/native/build.py. A copy of the JAX package's source of the same
// name.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 matvec(const double *lat, double a, double b, double c) {
  // row-vector convention: pos = frac @ lattice (rows are lattice vectors)
  return Vec3{a * lat[0] + b * lat[3] + c * lat[6],
              a * lat[1] + b * lat[4] + c * lat[7],
              a * lat[2] + b * lat[5] + c * lat[8]};
}

struct Edge {
  int64_t center, neighbor;
  int32_t img[3];
  double dist;
};

inline bool edge_less(const Edge &lhs, const Edge &rhs) {
  if (lhs.center != rhs.center) return lhs.center < rhs.center;
  if (lhs.neighbor != rhs.neighbor) return lhs.neighbor < rhs.neighbor;
  if (lhs.img[0] != rhs.img[0]) return lhs.img[0] < rhs.img[0];
  if (lhs.img[1] != rhs.img[1]) return lhs.img[1] < rhs.img[1];
  return lhs.img[2] < rhs.img[2];
}

struct UndirectedKey {
  int64_t lo, hi;
  int32_t img[3];
  bool operator==(const UndirectedKey &other) const {
    return lo == other.lo && hi == other.hi && img[0] == other.img[0] &&
           img[1] == other.img[1] && img[2] == other.img[2];
  }
};

struct UndirectedKeyHash {
  size_t operator()(const UndirectedKey &key) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t value) {
      h ^= value;
      h *= 1099511628211ull;
    };
    mix(static_cast<uint64_t>(key.lo));
    mix(static_cast<uint64_t>(key.hi));
    mix(static_cast<uint64_t>(static_cast<int64_t>(key.img[0])));
    mix(static_cast<uint64_t>(static_cast<int64_t>(key.img[1])));
    mix(static_cast<uint64_t>(static_cast<int64_t>(key.img[2])));
    return static_cast<size_t>(h);
  }
};

// plane spacing d_i = 1 / |row_i of inverse(lattice)^T| = 1/|col_i of inv|
void plane_spacings(const double *lat, double *out) {
  // inverse of 3x3 (row-major)
  double a = lat[0], b = lat[1], c = lat[2];
  double d = lat[3], e = lat[4], f = lat[5];
  double g = lat[6], h = lat[7], i = lat[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  double inv[9] = {
      (e * i - f * h) / det, (c * h - b * i) / det, (b * f - c * e) / det,
      (f * g - d * i) / det, (a * i - c * g) / det, (c * d - a * f) / det,
      (d * h - e * g) / det, (b * g - a * h) / det, (a * e - b * d) / det};
  // reciprocal rows (without 2 pi) are columns of inv; spacing = 1/norm
  for (int axis = 0; axis < 3; ++axis) {
    double nx = inv[axis];          // inv[0][axis]
    double ny = inv[3 + axis];      // inv[1][axis]
    double nz = inv[6 + axis];      // inv[2][axis]
    out[axis] = 1.0 / std::sqrt(nx * nx + ny * ny + nz * nz);
  }
}

}  // namespace

extern "C" {

struct ChgnetGraph {
  int64_t n_directed;
  int64_t n_undirected;
  int64_t n_angles;
  int64_t *atom_graph;       // [n_directed * 2]
  int64_t *neighbor_image;   // [n_directed * 3]
  int64_t *d2u;              // [n_directed]
  int64_t *u2d;              // [n_undirected]
  int64_t *bond_graph;       // [n_angles * 5]
  double *distances;         // [n_directed]
  int32_t error;             // 0 ok, 1 = unpaired directed edge
};

void chgnet_free_graph(ChgnetGraph *graph) {
  if (!graph) return;
  std::free(graph->atom_graph);
  std::free(graph->neighbor_image);
  std::free(graph->d2u);
  std::free(graph->u2d);
  std::free(graph->bond_graph);
  std::free(graph->distances);
  std::free(graph);
}

ChgnetGraph *chgnet_build_graph(int64_t n_atoms, const double *frac,
                                const double *lattice, double atom_cutoff,
                                double bond_cutoff, double tol) {
  auto *result = static_cast<ChgnetGraph *>(std::calloc(1, sizeof(ChgnetGraph)));
  if (n_atoms == 0) return result;

  // ----------------------------------------------------- neighbor search
  std::vector<Vec3> cart(n_atoms);
  double fmin[3] = {1e300, 1e300, 1e300}, fmax[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n_atoms; ++i) {
    const double *fc = frac + 3 * i;
    cart[i] = matvec(lattice, fc[0], fc[1], fc[2]);
    for (int axis = 0; axis < 3; ++axis) {
      fmin[axis] = std::min(fmin[axis], fc[axis]);
      fmax[axis] = std::max(fmax[axis], fc[axis]);
    }
  }
  double spacings[3];
  plane_spacings(lattice, spacings);
  int64_t n_img[3];
  for (int axis = 0; axis < 3; ++axis) {
    double spread = std::max(fmax[axis] - fmin[axis], 0.0);
    n_img[axis] = static_cast<int64_t>(
        std::ceil(atom_cutoff / spacings[axis] + spread + tol));
  }

  const double cutoff = atom_cutoff + tol;
  const double cutoff2 = cutoff * cutoff;

  // cartesian bounding box of the centers, expanded by the cutoff
  double bmin[3] = {1e300, 1e300, 1e300}, bmax[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n_atoms; ++i) {
    const double pos[3] = {cart[i].x, cart[i].y, cart[i].z};
    for (int axis = 0; axis < 3; ++axis) {
      bmin[axis] = std::min(bmin[axis], pos[axis]);
      bmax[axis] = std::max(bmax[axis], pos[axis]);
    }
  }
  for (int axis = 0; axis < 3; ++axis) {
    bmin[axis] -= cutoff + 1e-9;
    bmax[axis] += cutoff + 1e-9;
  }

  // uniform grid over the box with cell edge = cutoff
  int64_t ncell[3];
  for (int axis = 0; axis < 3; ++axis) {
    ncell[axis] = std::max<int64_t>(
        1, static_cast<int64_t>(std::floor((bmax[axis] - bmin[axis]) / cutoff)));
  }
  auto cell_of = [&](double x, double y, double z, int64_t idx[3]) {
    const double pos[3] = {x, y, z};
    for (int axis = 0; axis < 3; ++axis) {
      int64_t c = static_cast<int64_t>((pos[axis] - bmin[axis]) /
                                       (bmax[axis] - bmin[axis]) * ncell[axis]);
      idx[axis] = std::min(std::max<int64_t>(c, 0), ncell[axis] - 1);
    }
  };

  // candidate points: atom j shifted by image s, pruned to the box
  struct Candidate {
    Vec3 pos;
    int64_t atom;
    int32_t img[3];
  };
  // candidate generation THREADED over atom ranges (order within cands is
  // irrelevant: edges are re-sorted with a total-order comparator)
  std::vector<Vec3> shifts;
  std::vector<int32_t> shift_img;
  for (int64_t sa = -n_img[0]; sa <= n_img[0]; ++sa)
    for (int64_t sb = -n_img[1]; sb <= n_img[1]; ++sb)
      for (int64_t sc = -n_img[2]; sc <= n_img[2]; ++sc) {
        shifts.push_back(matvec(lattice, static_cast<double>(sa),
                                static_cast<double>(sb),
                                static_cast<double>(sc)));
        shift_img.push_back(static_cast<int32_t>(sa));
        shift_img.push_back(static_cast<int32_t>(sb));
        shift_img.push_back(static_cast<int32_t>(sc));
      }
  int n_cand_workers = static_cast<int>(
      std::min<int64_t>(std::max(1u, std::thread::hardware_concurrency()),
                        std::max<int64_t>(n_atoms / 1024, 1)));
  std::vector<std::vector<Candidate>> cand_parts(n_cand_workers);
  {
    int64_t chunk = (n_atoms + n_cand_workers - 1) / n_cand_workers;
    auto worker = [&](int t) {
      int64_t lo = t * chunk, hi = std::min(n_atoms, lo + chunk);
      std::vector<Candidate> &out = cand_parts[t];
      out.reserve(static_cast<size_t>(hi - lo) * 32);
      for (size_t si = 0; si < shifts.size(); ++si) {
        const Vec3 &shift = shifts[si];
        const int32_t *img = shift_img.data() + 3 * si;
        for (int64_t j = lo; j < hi; ++j) {
          Vec3 pos{cart[j].x + shift.x, cart[j].y + shift.y,
                   cart[j].z + shift.z};
          if (pos.x < bmin[0] || pos.x > bmax[0] || pos.y < bmin[1] ||
              pos.y > bmax[1] || pos.z < bmin[2] || pos.z > bmax[2])
            continue;
          out.push_back({pos, j, {img[0], img[1], img[2]}});
        }
      }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_cand_workers; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto &th : threads) th.join();
  }
  std::vector<Candidate> cands;
  {
    size_t total = 0;
    for (const auto &part : cand_parts) total += part.size();
    cands.reserve(total);
    for (auto &part : cand_parts) {
      cands.insert(cands.end(), part.begin(), part.end());
      part.clear();
      part.shrink_to_fit();
    }
  }

  // bin candidates
  const int64_t total_cells = ncell[0] * ncell[1] * ncell[2];
  std::vector<int64_t> cell_count(total_cells + 1, 0);
  std::vector<int64_t> cand_cell(cands.size());
  for (size_t k = 0; k < cands.size(); ++k) {
    int64_t idx[3];
    cell_of(cands[k].pos.x, cands[k].pos.y, cands[k].pos.z, idx);
    cand_cell[k] = (idx[0] * ncell[1] + idx[1]) * ncell[2] + idx[2];
    ++cell_count[cand_cell[k] + 1];
  }
  for (int64_t c = 0; c < total_cells; ++c) cell_count[c + 1] += cell_count[c];
  std::vector<int64_t> cell_items(cands.size());
  {
    std::vector<int64_t> cursor(cell_count.begin(), cell_count.end() - 1);
    for (size_t k = 0; k < cands.size(); ++k)
      cell_items[cursor[cand_cell[k]]++] = static_cast<int64_t>(k);
  }

  // query each center against its 27 neighboring cells — THREADED over
  // disjoint center ranges. Each worker sorts its own range with the
  // canonical comparator (center-major), so the concatenation of the
  // per-range results is globally sorted bit-for-bit like the old
  // single std::sort over all edges.
  int n_workers = static_cast<int>(
      std::min<int64_t>(std::max(1u, std::thread::hardware_concurrency()),
                        std::max<int64_t>(n_atoms / 1024, 1)));
  std::vector<std::vector<Edge>> edge_parts(n_workers);
  {
    int64_t chunk = (n_atoms + n_workers - 1) / n_workers;
    auto worker = [&](int t) {
      int64_t lo = t * chunk;
      int64_t hi = std::min(n_atoms, lo + chunk);
      std::vector<Edge> &out = edge_parts[t];
      out.reserve(static_cast<size_t>(hi - lo) * 48);
      for (int64_t i = lo; i < hi; ++i) {
        int64_t idx[3];
        cell_of(cart[i].x, cart[i].y, cart[i].z, idx);
        for (int64_t da = -1; da <= 1; ++da)
          for (int64_t db = -1; db <= 1; ++db)
            for (int64_t dc = -1; dc <= 1; ++dc) {
              int64_t ca = idx[0] + da, cb = idx[1] + db, cc = idx[2] + dc;
              if (ca < 0 || ca >= ncell[0] || cb < 0 || cb >= ncell[1] ||
                  cc < 0 || cc >= ncell[2])
                continue;
              int64_t cell = (ca * ncell[1] + cb) * ncell[2] + cc;
              for (int64_t p = cell_count[cell]; p < cell_count[cell + 1];
                   ++p) {
                const Candidate &cand = cands[cell_items[p]];
                double dx = cand.pos.x - cart[i].x;
                double dy = cand.pos.y - cart[i].y;
                double dz = cand.pos.z - cart[i].z;
                double d2 = dx * dx + dy * dy + dz * dz;
                if (d2 > cutoff2) continue;
                double dist = std::sqrt(d2);
                if (dist <= tol) continue;  // self at zero image
                out.push_back({i,
                               cand.atom,
                               {cand.img[0], cand.img[1], cand.img[2]},
                               dist});
              }
            }
      }
      std::sort(out.begin(), out.end(), edge_less);
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_workers; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto &th : threads) th.join();
  }
  std::vector<Edge> edges;
  {
    size_t total = 0;
    for (const auto &part : edge_parts) total += part.size();
    edges.reserve(total);
    for (auto &part : edge_parts) {
      edges.insert(edges.end(), part.begin(), part.end());
      part.clear();
      part.shrink_to_fit();
    }
  }
  const int64_t n_dir = static_cast<int64_t>(edges.size());

  // ------------------------------------------- directed -> undirected pairing
  std::vector<int64_t> d2u(n_dir);
  std::vector<int64_t> u2d;        // first directed member per undirected
  std::vector<int64_t> second_d;   // second directed member
  u2d.reserve(n_dir / 2);
  second_d.reserve(n_dir / 2);
  {
    std::unordered_map<UndirectedKey, int64_t, UndirectedKeyHash> seen;
    seen.reserve(static_cast<size_t>(n_dir));
    for (int64_t e = 0; e < n_dir; ++e) {
      const Edge &edge = edges[e];
      UndirectedKey key{};
      if (edge.center < edge.neighbor) {
        key.lo = edge.center;
        key.hi = edge.neighbor;
        key.img[0] = edge.img[0];
        key.img[1] = edge.img[1];
        key.img[2] = edge.img[2];
      } else if (edge.center > edge.neighbor) {
        key.lo = edge.neighbor;
        key.hi = edge.center;
        key.img[0] = -edge.img[0];
        key.img[1] = -edge.img[1];
        key.img[2] = -edge.img[2];
      } else {  // self-edge: canonical image by lexicographic sign choice
        key.lo = key.hi = edge.center;
        bool flip = (edge.img[0] < -edge.img[0]) ||
                    (edge.img[0] == -edge.img[0] && edge.img[1] < -edge.img[1]) ||
                    (edge.img[0] == -edge.img[0] &&
                     edge.img[1] == -edge.img[1] && edge.img[2] < -edge.img[2]);
        for (int axis = 0; axis < 3; ++axis)
          key.img[axis] = flip ? -edge.img[axis] : edge.img[axis];
      }
      auto it = seen.find(key);
      if (it == seen.end()) {
        int64_t uid = static_cast<int64_t>(u2d.size());
        seen.emplace(key, uid);
        d2u[e] = uid;
        u2d.push_back(e);
        second_d.push_back(-1);
      } else {
        d2u[e] = it->second;
        if (second_d[it->second] != -1) {
          result->error = 1;  // more than two members
        }
        second_d[it->second] = e;
      }
    }
    for (int64_t u = 0; u < static_cast<int64_t>(u2d.size()); ++u)
      if (second_d[u] == -1) result->error = 1;  // unpaired
  }
  const int64_t n_und = static_cast<int64_t>(u2d.size());

  // ------------------------------------------------------------- line graph
  // per-center CSR of directed edges with d < bond_cutoff (strict),
  // ascending directed index (edges are center-sorted already)
  std::vector<int64_t> short_edges;
  short_edges.reserve(n_dir);
  std::vector<int64_t> offsets(n_atoms + 1, 0);
  // comparisons match the numpy builder exactly (builder.py:149,155):
  // right bonds strictly d < cutoff, left bonds d <= cutoff
  for (int64_t e = 0; e < n_dir; ++e)
    if (edges[e].dist < bond_cutoff) {
      short_edges.push_back(e);
      ++offsets[edges[e].center + 1];
    }
  for (int64_t a = 0; a < n_atoms; ++a) offsets[a + 1] += offsets[a];

  // THREADED two-pass enumeration: exact per-bond row counts, prefix
  // sum, then parallel fill at exact offsets — row order is bit-for-bit
  // the sequential (u, member, ascending directed index) order.
  std::vector<int64_t> bond_rows;  // 5 per row
  if (result->error == 0 && n_und > 0) {
    std::vector<int64_t> row_off(n_und + 1, 0);
    int64_t chunk_u = (n_und + n_workers - 1) / n_workers;
    auto count_worker = [&](int t) {
      int64_t lo = t * chunk_u, hi = std::min<int64_t>(n_und, lo + chunk_u);
      for (int64_t u = lo; u < hi; ++u) {
        if (edges[u2d[u]].dist > bond_cutoff) continue;
        int64_t rows = 0;
        const int64_t members[2] = {u2d[u], second_d[u]};
        for (int m = 0; m < 2; ++m) {
          int64_t e = members[m];
          int64_t c = edges[e].center;
          rows += offsets[c + 1] - offsets[c];
          if (edges[e].dist < bond_cutoff) --rows;  // the member itself
        }
        row_off[u + 1] = rows;
      }
    };
    {
      std::vector<std::thread> threads;
      for (int t = 1; t < n_workers; ++t)
        threads.emplace_back(count_worker, t);
      count_worker(0);
      for (auto &th : threads) th.join();
    }
    for (int64_t u = 0; u < n_und; ++u) row_off[u + 1] += row_off[u];
    bond_rows.resize(static_cast<size_t>(row_off[n_und]) * 5);
    auto fill_worker = [&](int t) {
      int64_t lo = t * chunk_u, hi = std::min<int64_t>(n_und, lo + chunk_u);
      for (int64_t u = lo; u < hi; ++u) {
        if (edges[u2d[u]].dist > bond_cutoff) continue;
        int64_t *row = bond_rows.data() + row_off[u] * 5;
        const int64_t members[2] = {u2d[u], second_d[u]};
        for (int m = 0; m < 2; ++m) {
          int64_t e = members[m];
          int64_t c = edges[e].center;
          for (int64_t p = offsets[c]; p < offsets[c + 1]; ++p) {
            int64_t other = short_edges[p];
            if (other == e) continue;
            row[0] = c;
            row[1] = u;
            row[2] = e;
            row[3] = d2u[other];
            row[4] = other;
            row += 5;
          }
        }
      }
    };
    {
      std::vector<std::thread> threads;
      for (int t = 1; t < n_workers; ++t)
        threads.emplace_back(fill_worker, t);
      fill_worker(0);
      for (auto &th : threads) th.join();
    }
  }
  const int64_t n_angles = static_cast<int64_t>(bond_rows.size() / 5);

  // -------------------------------------------------------------- marshal
  result->n_directed = n_dir;
  result->n_undirected = n_und;
  result->n_angles = n_angles;
  result->atom_graph =
      static_cast<int64_t *>(std::malloc(sizeof(int64_t) * 2 * n_dir));
  result->neighbor_image =
      static_cast<int64_t *>(std::malloc(sizeof(int64_t) * 3 * n_dir));
  result->d2u = static_cast<int64_t *>(std::malloc(sizeof(int64_t) * n_dir));
  result->u2d = static_cast<int64_t *>(std::malloc(sizeof(int64_t) * n_und));
  result->distances =
      static_cast<double *>(std::malloc(sizeof(double) * n_dir));
  result->bond_graph =
      static_cast<int64_t *>(std::malloc(sizeof(int64_t) * 5 * n_angles));
  for (int64_t e = 0; e < n_dir; ++e) {
    result->atom_graph[2 * e] = edges[e].center;
    result->atom_graph[2 * e + 1] = edges[e].neighbor;
    result->neighbor_image[3 * e] = edges[e].img[0];
    result->neighbor_image[3 * e + 1] = edges[e].img[1];
    result->neighbor_image[3 * e + 2] = edges[e].img[2];
    result->d2u[e] = d2u[e];
    result->distances[e] = edges[e].dist;
  }
  std::memcpy(result->u2d, u2d.data(), sizeof(int64_t) * n_und);
  std::memcpy(result->bond_graph, bond_rows.data(),
              sizeof(int64_t) * 5 * n_angles);
  return result;
}

}  // extern "C"
