// Cluster resource scheduler — node selection policies and placement-group
// bundle packing, as a process-embeddable C++ library.
//
// Role-equivalent to the reference's raylet scheduling stack (reference:
// src/ray/raylet/scheduling/cluster_resource_scheduler.h:44,
// policy/hybrid_scheduling_policy.h:50, policy/bundle_scheduling_policy.h:82-106,
// policy/scorer.h:41 LeastResourceScorer) and its fixed-point resource model
// (reference: src/ray/common/scheduling/fixed_point.h, resource_set.h,
// cluster_resource_data.h). Differences for the TPU rebuild:
//  - resources are interned string -> index maps per cluster state, with
//    fixed-point (x10000) arithmetic so fractional CPUs/chips are exact;
//  - TPU gang constraints surface as label-style resources
//    ("TPU-v5p-8-head") handled uniformly as custom resources;
//  - the whole scheduler is a passive library: the Python/daemon layers feed
//    node updates in and ask for decisions, so the identical logic runs in
//    the head (GCS placement) and in each node daemon (spillback checks).
//
// Exposed C API (used via ctypes from ray_tpu/core/_native.py):
//   cluster_new/free, cluster_add_node, cluster_remove_node,
//   cluster_update_available, cluster_schedule (hybrid/spread/random/
//   node_affinity), cluster_schedule_bundles (PACK/SPREAD/STRICT_*),
//   cluster_acquire/release (resource bookkeeping).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <random>
#include <string>
#include <vector>

namespace {

using FixedPoint = int64_t;  // value * 10000
constexpr FixedPoint kUnit = 10000;

struct ResourceSet {
  // resource index -> amount (sparse)
  std::map<int, FixedPoint> amounts;

  bool covers(const ResourceSet& demand) const {
    for (const auto& [idx, amt] : demand.amounts) {
      auto it = amounts.find(idx);
      if (it == amounts.end() || it->second < amt) return false;
    }
    return true;
  }
  void subtract(const ResourceSet& demand) {
    for (const auto& [idx, amt] : demand.amounts) amounts[idx] -= amt;
  }
  void add(const ResourceSet& demand) {
    for (const auto& [idx, amt] : demand.amounts) amounts[idx] += amt;
  }
};

struct Node {
  std::string id;
  ResourceSet total;
  ResourceSet available;
  bool alive = true;
  std::map<std::string, std::string> labels;
};

struct Cluster {
  std::vector<Node> nodes;                    // dense, dead nodes compacted out
  std::map<std::string, int> node_index;      // id -> index
  std::map<std::string, int> resource_ids;    // name -> index (interned)
  std::mt19937_64 rng{0x52545055};
  float spread_threshold = 0.5f;

  int intern(const std::string& name) {
    auto it = resource_ids.find(name);
    if (it != resource_ids.end()) return it->second;
    int idx = (int)resource_ids.size();
    resource_ids.emplace(name, idx);
    return idx;
  }
};

// Wire format for resource sets crossing the C boundary:
//   n_entries u32, then per entry: name_len u32, name bytes, amount_fp i64
ResourceSet parse_resources(Cluster* c, const uint8_t* buf, uint64_t len) {
  ResourceSet rs;
  if (len < 4) return rs;
  uint32_t n;
  memcpy(&n, buf, 4);
  uint64_t off = 4;
  for (uint32_t i = 0; i < n && off + 4 <= len; i++) {
    uint32_t name_len;
    memcpy(&name_len, buf + off, 4);
    off += 4;
    std::string name(reinterpret_cast<const char*>(buf + off), name_len);
    off += name_len;
    int64_t amt;
    memcpy(&amt, buf + off, 8);
    off += 8;
    rs.amounts[c->intern(name)] += amt;
  }
  return rs;
}

// LeastResourceScorer (reference: policy/scorer.h:41): score a node for a
// demand = sum over demanded resources of available/total after placement;
// higher is better for PACK (critical resources get used up), we invert for
// spread. We implement the reference's hybrid scoring: utilization-based.
float node_utilization_after(const Node& n, const ResourceSet& demand) {
  float worst = 0.0f;
  for (const auto& [idx, amt] : demand.amounts) {
    auto tot_it = n.total.amounts.find(idx);
    if (tot_it == n.total.amounts.end() || tot_it->second == 0) return 1.0f;
    auto avail_it = n.available.amounts.find(idx);
    FixedPoint avail = avail_it == n.available.amounts.end() ? 0 : avail_it->second;
    float util = 1.0f - (float)(avail - amt) / (float)tot_it->second;
    worst = std::max(worst, util);
  }
  return worst;
}

enum Policy : int {
  kHybrid = 0,
  kSpread = 1,
  kRandom = 2,
  kNodeAffinity = 3,
};

enum BundleStrategy : int {
  kPack = 0,
  kBundleSpread = 1,
  kStrictPack = 2,
  kStrictSpread = 3,
};

}  // namespace

extern "C" {

void* rtpu_cluster_new() { return new Cluster(); }
void rtpu_cluster_free(void* h) { delete reinterpret_cast<Cluster*>(h); }

void rtpu_cluster_set_spread_threshold(void* h, float t) {
  reinterpret_cast<Cluster*>(h)->spread_threshold = t;
}

int rtpu_cluster_add_node(void* h, const char* node_id, const uint8_t* res,
                          uint64_t res_len) {
  auto* c = reinterpret_cast<Cluster*>(h);
  if (c->node_index.count(node_id)) return -1;
  Node n;
  n.id = node_id;
  n.total = parse_resources(c, res, res_len);
  n.available = n.total;
  c->node_index[n.id] = (int)c->nodes.size();
  c->nodes.push_back(std::move(n));
  return 0;
}

int rtpu_cluster_remove_node(void* h, const char* node_id) {
  auto* c = reinterpret_cast<Cluster*>(h);
  auto it = c->node_index.find(node_id);
  if (it == c->node_index.end()) return -1;
  int idx = it->second;
  c->node_index.erase(it);
  c->nodes.erase(c->nodes.begin() + idx);
  c->node_index.clear();
  for (int i = 0; i < (int)c->nodes.size(); i++) c->node_index[c->nodes[i].id] = i;
  return 0;
}

// Replace a node's available resources (gossip update from the node daemon;
// reference: ray_syncer.h resource broadcast).
int rtpu_cluster_update_available(void* h, const char* node_id,
                                  const uint8_t* res, uint64_t res_len) {
  auto* c = reinterpret_cast<Cluster*>(h);
  auto it = c->node_index.find(node_id);
  if (it == c->node_index.end()) return -1;
  c->nodes[it->second].available = parse_resources(c, res, res_len);
  return 0;
}

// Book-keep an allocation decided elsewhere. Returns 0 on success, -1 if the
// node can no longer cover the demand (caller should reschedule).
int rtpu_cluster_acquire(void* h, const char* node_id, const uint8_t* res,
                         uint64_t res_len) {
  auto* c = reinterpret_cast<Cluster*>(h);
  auto it = c->node_index.find(node_id);
  if (it == c->node_index.end()) return -1;
  Node& n = c->nodes[it->second];
  ResourceSet demand = parse_resources(c, res, res_len);
  if (!n.available.covers(demand)) return -1;
  n.available.subtract(demand);
  return 0;
}

int rtpu_cluster_release(void* h, const char* node_id, const uint8_t* res,
                         uint64_t res_len) {
  auto* c = reinterpret_cast<Cluster*>(h);
  auto it = c->node_index.find(node_id);
  if (it == c->node_index.end()) return -1;
  Node& n = c->nodes[it->second];
  n.available.add(parse_resources(c, res, res_len));
  return 0;
}

// Pick a node for one task. Returns index into out_node_id (caller buffer of
// >=64 bytes) or -1 if infeasible everywhere.
// policy: Policy enum. affinity_node: used by kNodeAffinity (soft flag says
// whether to fall back to hybrid when the target is infeasible).
int rtpu_cluster_schedule(void* h, const uint8_t* res, uint64_t res_len,
                          int policy, const char* affinity_node, int soft,
                          char* out_node_id) {
  auto* c = reinterpret_cast<Cluster*>(h);
  ResourceSet demand = parse_resources(c, res, res_len);

  if (policy == kNodeAffinity && affinity_node && affinity_node[0]) {
    auto it = c->node_index.find(affinity_node);
    if (it != c->node_index.end() && c->nodes[it->second].available.covers(demand)) {
      strncpy(out_node_id, affinity_node, 63);
      out_node_id[63] = 0;
      return 0;
    }
    if (!soft) return -1;
    policy = kHybrid;
  }

  std::vector<int> feasible;
  for (int i = 0; i < (int)c->nodes.size(); i++) {
    if (c->nodes[i].alive && c->nodes[i].available.covers(demand)) {
      feasible.push_back(i);
    }
  }
  if (feasible.empty()) return -1;

  int chosen = -1;
  if (policy == kRandom) {
    chosen = feasible[c->rng() % feasible.size()];
  } else if (policy == kSpread) {
    // round-robin-ish: lowest utilization first (reference spread policy)
    float best = 2.0f;
    for (int i : feasible) {
      float u = node_utilization_after(c->nodes[i], demand);
      if (u < best) {
        best = u;
        chosen = i;
      }
    }
  } else {  // hybrid: pack onto nodes below threshold (prefer highest
            // utilization below threshold => consolidation), else spread
            // (reference: policy/hybrid_scheduling_policy.h:50)
    float best_pack = -1.0f;
    int pack_node = -1;
    float best_spread = 2.0f;
    int spread_node = -1;
    for (int i : feasible) {
      float u = node_utilization_after(c->nodes[i], demand);
      if (u <= c->spread_threshold) {
        if (u > best_pack) {
          best_pack = u;
          pack_node = i;
        }
      }
      if (u < best_spread) {
        best_spread = u;
        spread_node = i;
      }
    }
    chosen = pack_node >= 0 ? pack_node : spread_node;
  }
  if (chosen < 0) return -1;
  strncpy(out_node_id, c->nodes[chosen].id.c_str(), 63);
  out_node_id[63] = 0;
  return 0;
}

// Placement-group bundle scheduling (reference:
// policy/bundle_scheduling_policy.h:82-106 — PACK/SPREAD/STRICT_PACK/
// STRICT_SPREAD). Input: n_bundles resource sets concatenated (each prefixed
// with u64 byte length). Output: out_assignments gets n_bundles node-id
// strings of 64 bytes each. All-or-nothing: returns -1 and changes nothing
// if the set cannot be placed.
int rtpu_cluster_schedule_bundles(void* h, const uint8_t* bundles,
                                  uint64_t bundles_len, uint32_t n_bundles,
                                  int strategy, char* out_assignments) {
  auto* c = reinterpret_cast<Cluster*>(h);
  std::vector<ResourceSet> demands;
  uint64_t off = 0;
  for (uint32_t i = 0; i < n_bundles; i++) {
    if (off + 8 > bundles_len) return -2;
    uint64_t blen;
    memcpy(&blen, bundles + off, 8);
    off += 8;
    demands.push_back(parse_resources(c, bundles + off, blen));
    off += blen;
  }

  // Work on a copy of availability; commit only on success.
  std::vector<ResourceSet> avail;
  avail.reserve(c->nodes.size());
  for (auto& n : c->nodes) avail.push_back(n.available);

  std::vector<int> assignment(n_bundles, -1);

  auto covers = [&](int node, const ResourceSet& d) {
    return c->nodes[node].alive && avail[node].covers(d);
  };

  if (strategy == kStrictPack) {
    // all bundles on one node
    for (int i = 0; i < (int)c->nodes.size(); i++) {
      ResourceSet tmp = avail[i];
      bool ok = true;
      for (auto& d : demands) {
        if (!c->nodes[i].alive || !tmp.covers(d)) {
          ok = false;
          break;
        }
        tmp.subtract(d);
      }
      if (ok) {
        for (uint32_t b = 0; b < n_bundles; b++) assignment[b] = i;
        break;
      }
    }
  } else if (strategy == kStrictSpread) {
    // each bundle on a distinct node; greedy biggest-first
    std::vector<uint32_t> order(n_bundles);
    for (uint32_t i = 0; i < n_bundles; i++) order[i] = i;
    std::vector<bool> used(c->nodes.size(), false);
    bool ok = true;
    for (uint32_t b : order) {
      int pick = -1;
      float best = 2.0f;
      for (int i = 0; i < (int)c->nodes.size(); i++) {
        if (used[i] || !covers(i, demands[b])) continue;
        float u = node_utilization_after(c->nodes[i], demands[b]);
        if (u < best) {
          best = u;
          pick = i;
        }
      }
      if (pick < 0) {
        ok = false;
        break;
      }
      used[pick] = true;
      avail[pick].subtract(demands[b]);
      assignment[b] = pick;
    }
    if (!ok) return -1;
  } else {
    // PACK (best effort consolidate) / SPREAD (best effort distribute)
    for (uint32_t b = 0; b < n_bundles; b++) {
      int pick = -1;
      float best = strategy == kPack ? -1.0f : 2.0f;
      for (int i = 0; i < (int)c->nodes.size(); i++) {
        if (!covers(i, demands[b])) continue;
        float u = node_utilization_after(c->nodes[i], demands[b]);
        bool better = strategy == kPack ? u > best : u < best;
        if (better) {
          best = u;
          pick = i;
        }
      }
      if (pick < 0) return -1;
      avail[pick].subtract(demands[b]);
      assignment[b] = pick;
    }
  }

  for (uint32_t b = 0; b < n_bundles; b++) {
    if (assignment[b] < 0) return -1;
  }
  // commit
  for (uint32_t b = 0; b < n_bundles; b++) {
    c->nodes[assignment[b]].available.subtract(demands[b]);
    strncpy(out_assignments + 64 * b, c->nodes[assignment[b]].id.c_str(), 63);
    out_assignments[64 * b + 63] = 0;
  }
  return 0;
}

uint32_t rtpu_cluster_num_nodes(void* h) {
  return (uint32_t)reinterpret_cast<Cluster*>(h)->nodes.size();
}

}  // extern "C"
