// ASCII fabric-topology graph, native tier.
//
// Counterpart of the reference's switch-tree visualizer (reference
// cpp/netcommunicators.hpp:79-290), which allgathers per-rank
// SLURM_TOPOLOGY_ADDR dot-paths and draws switch -> node -> process.  On
// a GPU cluster the hierarchy is host (one NVLink domain) -> card; hosts
// are joined by the network.  Rank placement comes from the environment
// instead of SLURM:
//   DLNB_TOPOLOGY   comma-separated dot-paths, one per rank,
//                   e.g. "h0.0,h0.1,h1.0,h1.1" (host.card)
//   otherwise       a synthetic tree of eight cards a host is drawn (an
//                   HGX H100 board), mirroring the reference's
//                   non-SLURM fallback (netcommunicators.hpp:148-157).
// Output format follows the Python tier's utils/topology.py tree.
#pragma once

#include <cstdlib>
#include <map>
#include <ostream>
#include <sstream>
#include <string>
#include <vector>

namespace dlnb {

struct RankPlacement {
  std::string host_name;
  int card;
  int rank;
};

inline std::vector<std::string> split_csv(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::string cur;
  for (char c : s) {
    if (c == sep) {
      out.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  out.push_back(cur);
  return out;
}

inline constexpr int kCardsPerHost = 8;

// Resolve per-rank placements from DLNB_TOPOLOGY or synthesize hosts of
// kCardsPerHost cards.
inline std::vector<RankPlacement> resolve_placements(int world_size) {
  std::vector<RankPlacement> out;
  const char* env = std::getenv("DLNB_TOPOLOGY");
  if (env && *env) {
    auto paths = split_csv(env, ',');
    for (int r = 0; r < world_size; ++r) {
      std::string p = r < static_cast<int>(paths.size()) ? paths[r] : "h0";
      auto parts = split_csv(p, '.');
      int card = r;
      if (parts.size() > 1 && !parts[1].empty())
        card = std::atoi(parts[1].c_str());
      out.push_back({parts.empty() ? "h0" : parts[0], card, r});
    }
    return out;
  }
  for (int r = 0; r < world_size; ++r)
    out.push_back({"host" + std::to_string(r / kCardsPerHost),
                   r % kCardsPerHost, r});
  return out;
}

inline std::string format_topology(int world_size,
                                   const std::string& kind = "shm-rank") {
  auto placements = resolve_placements(world_size);
  // host -> ranks, insertion-ordered by first appearance
  std::vector<std::string> host_order;
  std::map<std::string, std::vector<RankPlacement>> host_ranks;
  for (const auto& p : placements) {
    if (host_ranks.find(p.host_name) == host_ranks.end())
      host_order.push_back(p.host_name);
    host_ranks[p.host_name].push_back(p);
  }

  std::ostringstream os;
  std::size_t n_hosts = host_order.size();
  os << "fabric: " << world_size << " x " << kind << " (" << n_hosts
     << " host" << (n_hosts != 1 ? "s" : "")
     << (n_hosts > 1 ? ", network-linked" : "") << ")\n";
  for (std::size_t hi = 0; hi < n_hosts; ++hi) {
    const auto& h = host_order[hi];
    bool h_last = hi == n_hosts - 1;
    const auto& ranks = host_ranks[h];
    os << (h_last ? "└── " : "├── ") << "host " << h
       << "  [NVLink domain, " << ranks.size() << " card(s)]\n";
    std::string h_pad = h_last ? "    " : "│   ";
    for (std::size_t di = 0; di < ranks.size(); ++di)
      os << h_pad << (di == ranks.size() - 1 ? "└── " : "├── ")
         << "rank id=" << ranks[di].rank << "  card=" << ranks[di].card
         << "\n";
  }
  return os.str();
}

inline void print_topology(int world_size, std::ostream& os,
                           const std::string& kind = "shm-rank") {
  os << format_topology(world_size, kind);
}

}  // namespace dlnb
