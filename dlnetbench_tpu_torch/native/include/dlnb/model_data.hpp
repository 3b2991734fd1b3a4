// Model data layer: keyed stats-file parser + architecture-card parser.
//
// Counterpart of the reference's `get_model_stats` / `count_layers`
// (reference cpp/utils.hpp:200-294).  The reference parses stat files by
// LINE ORDER and silently mis-parses drifted files (SURVEY.md §7.4); this
// parser is keyed and case-insensitive, matching the Python tier
// (dlnetbench_tpu_torch/core/model_stats.py) so both tiers read the same 72+
// data files identically.
#pragma once

#include <algorithm>
#include <cstdint>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <string>

#include "dlnb/json.hpp"

namespace dlnb {

struct ModelStats {
  std::string name;  // e.g. "llama3_8b_16_bfloat16"
  std::int64_t forward_flops = 0;
  std::int64_t backward_flops = 0;
  std::int64_t model_size = 0;  // parameter count (elements)
  double fwd_us = 0.0;
  double bwd_us = 0.0;
  std::int64_t batch_size = 0;
  std::int64_t seq_len = 0;
  std::int64_t embed_dim = 0;
  std::string dtype;
  std::int64_t non_expert_size = 0;
  double ffn_fwd_us = 0.0;
  double ffn_bwd_us = 0.0;
  std::int64_t experts = 1;
  std::string device = "unknown";
  double bytes_per_element = 2.0;
  // backward-aware step roofline (core/roofline.py train_step_time_s);
  // 0 in files predating r4
  double step_us = 0.0;

  std::int64_t model_bytes() const {
    return static_cast<std::int64_t>(model_size * bytes_per_element);
  }
};

struct ModelCard {
  std::string name;
  std::int64_t embed_dim = 0;
  std::int64_t num_heads = 0;
  std::int64_t num_kv_heads = 0;  // 0 -> num_heads (MHA)
  std::int64_t ff_dim = 0;
  std::int64_t seq_len = 0;
  std::int64_t num_encoder_blocks = 0;
  std::int64_t num_decoder_blocks = 0;
  std::int64_t vocab_size = 0;
  bool gated_mlp = false;
  std::int64_t num_experts = 1;
  std::int64_t top_k = 1;

  std::int64_t num_layers() const {
    // reference count_layers sums encoder+decoder blocks (utils.hpp:279-294)
    return num_encoder_blocks + num_decoder_blocks;
  }
  std::int64_t kv_dim() const {
    std::int64_t kvh = num_kv_heads > 0 ? num_kv_heads : num_heads;
    return num_heads > 0 ? embed_dim / num_heads * kvh : embed_dim;
  }
};

namespace detail {
inline std::string lower(std::string s) {
  std::transform(s.begin(), s.end(), s.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  return s;
}
inline std::string strip(const std::string& s) {
  auto b = s.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  auto e = s.find_last_not_of(" \t\r\n");
  return s.substr(b, e - b + 1);
}
}  // namespace detail

// Parse the flat `Key:value` stat-file text (keyed; tolerates reordered or
// case-drifted lines, unlike reference utils.hpp:211-253).
inline ModelStats parse_model_stats(const std::string& text,
                                    const std::string& name) {
  ModelStats st;
  st.name = name;
  bool have_fwd = false, have_bwd = false, have_size = false;
  std::istringstream is(text);
  std::string line;
  while (std::getline(is, line)) {
    line = detail::strip(line);
    if (line.empty() || line[0] == '#') continue;
    auto colon = line.find(':');
    if (colon == std::string::npos) continue;
    std::string key = detail::lower(detail::strip(line.substr(0, colon)));
    std::string val = detail::strip(line.substr(colon + 1));
    try {
      if (key == "forward_flops") st.forward_flops = std::stoll(val);
      else if (key == "backward_flops") st.backward_flops = std::stoll(val);
      else if (key == "model_size") { st.model_size = std::stoll(val); have_size = true; }
      else if (key == "non_expert_size") st.non_expert_size = std::stoll(val);
      else if (key == "average_forward_time (us)") { st.fwd_us = std::stod(val); have_fwd = true; }
      else if (key == "average_backward_time (us)") { st.bwd_us = std::stod(val); have_bwd = true; }
      else if (key == "batch_size") st.batch_size = std::stoll(val);
      else if (key == "ffn_average_forward_time (us)") st.ffn_fwd_us = std::stod(val);
      else if (key == "ffn_average_backward_time (us)") st.ffn_bwd_us = std::stod(val);
      else if (key == "experts") st.experts = std::stoll(val);
      else if (key == "seq_len") st.seq_len = std::stoll(val);
      else if (key == "embedded_dim" || key == "embed_dim") st.embed_dim = std::stoll(val);
      else if (key == "device") st.device = val;
      else if (key == "dtype") st.dtype = val;
      else if (key == "bytes_per_element") st.bytes_per_element = std::stod(val);
      else if (key == "train_step_time (us)") st.step_us = std::stod(val);
      // unknown keys ignored: files may grow fields
    } catch (const std::exception&) {
      throw std::runtime_error("stats '" + name + "': bad value for key '" +
                               key + "': '" + val + "'");
    }
  }
  if (!have_size || !have_fwd || !have_bwd)
    throw std::runtime_error("stats '" + name +
                             "': missing required field(s) "
                             "(Model_Size / forward / backward time)");
  return st;
}

inline ModelStats load_model_stats(const std::string& path,
                                   const std::string& name = "") {
  std::ifstream f(path);
  if (!f) throw std::runtime_error("cannot open stats file: " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  std::string n = name;
  if (n.empty()) {
    auto slash = path.find_last_of('/');
    n = slash == std::string::npos ? path : path.substr(slash + 1);
    auto dot = n.rfind(".txt");
    if (dot != std::string::npos) n = n.substr(0, dot);
  }
  return parse_model_stats(ss.str(), n);
}

// Architecture-card JSON (same schema as dlnetbench_tpu_torch/data/models/*.json
// and the reference's models/*.json).
inline ModelCard parse_model_card(const Json& j, const std::string& name) {
  ModelCard c;
  c.name = name;
  auto geti = [&](const char* key, std::int64_t dflt) -> std::int64_t {
    return j.contains(key) ? j.at(key).as_int() : dflt;
  };
  c.embed_dim = geti("embed_dim", 0);
  c.num_heads = geti("num_heads", 0);
  c.num_kv_heads = geti("num_kv_heads", 0);
  c.ff_dim = geti("ff_dim", 0);
  c.seq_len = geti("seq_len", 0);
  c.num_encoder_blocks = geti("num_encoder_blocks", 0);
  c.num_decoder_blocks = geti("num_decoder_blocks", 0);
  c.vocab_size = geti("vocab_size", 0);
  if (j.contains("gated_mlp")) c.gated_mlp = j.at("gated_mlp").as_bool();
  if (j.contains("moe_params")) {
    const Json& m = j.at("moe_params");
    c.num_experts = m.contains("num_experts") ? m.at("num_experts").as_int() : 1;
    c.top_k = m.contains("num_experts_per_tok")
                  ? m.at("num_experts_per_tok").as_int() : 1;
  }
  return c;
}

inline ModelCard load_model_card(const std::string& path,
                                 const std::string& name = "") {
  std::ifstream f(path);
  if (!f) throw std::runtime_error("cannot open model card: " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  std::string n = name;
  if (n.empty()) {
    auto slash = path.find_last_of('/');
    n = slash == std::string::npos ? path : path.substr(slash + 1);
    auto dot = n.rfind(".json");
    if (dot != std::string::npos) n = n.substr(0, dot);
  }
  return parse_model_card(Json::parse(ss.str()), n);
}

// "llama3_8b_16_bfloat16" -> "llama3_8b" (strip batch + dtype suffixes,
// reference hybrid_2d.cpp:214-216 semantics, keyed on the last two '_').
inline std::string arch_name_from_stats_name(const std::string& stats_name) {
  auto p1 = stats_name.find_last_of('_');
  if (p1 == std::string::npos) return stats_name;
  auto p2 = stats_name.find_last_of('_', p1 - 1);
  if (p2 == std::string::npos) return stats_name;
  return stats_name.substr(0, p2);
}

}  // namespace dlnb
