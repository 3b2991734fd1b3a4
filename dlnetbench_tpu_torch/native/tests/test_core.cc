// Unit tests: JSON, model data parsing, schedule algebra, dtype math.
#include "dlnb_test.hpp"

#include "dlnb/json.hpp"
#include "dlnb/model_data.hpp"
#include "dlnb/schedule.hpp"
#include "dlnb/tensor.hpp"

using namespace dlnb;

// --------------------------------------------------------------- JSON
TEST(json_roundtrip) {
  Json v = Json::parse(
      R"({"a": 1, "b": [1, 2.5, "x"], "c": {"d": true, "e": null},)"
      R"( "big": 4785074604081152, "s": "q\"\né"})");
  CHECK_EQ(v.at("a").as_int(), 1);
  CHECK_EQ(v.at("b").items().size(), std::size_t{3});
  CHECK_NEAR(v.at("b").items()[1].as_double(), 2.5, 1e-12);
  CHECK(v.at("c").at("d").as_bool());
  CHECK(v.at("c").at("e").is_null());
  CHECK_EQ(v.at("big").as_int(), 4785074604081152LL);
  Json back = Json::parse(v.dump());
  CHECK_EQ(back.at("big").as_int(), 4785074604081152LL);
  CHECK_EQ(back.at("s").as_string(), v.at("s").as_string());
}

TEST(json_errors) {
  CHECK_THROWS(Json::parse("{"));
  CHECK_THROWS(Json::parse("[1,]"));
  CHECK_THROWS(Json::parse("1 2"));
  CHECK_THROWS(Json::parse("{\"a\" 1}"));
}

TEST(json_double_format) {
  // doubles must round-trip and stay doubles
  Json v(1234.5);
  Json back = Json::parse(v.dump());
  CHECK_NEAR(back.as_double(), 1234.5, 0);
  Json whole(2.0);
  CHECK(Json::parse(whole.dump()).type() == Json::Type::Double);
}

// --------------------------------------------------------- model data
static const char* kStatsText =
    "Forward_Flops:2392537302040576\n"
    "Backward_Flops:4785074604081152\n"
    "Model_Size:8030261248\n"
    "Non_Expert_size:0\n"
    "Average_Forward_Time (us):5212499.57\n"
    "Average_Backward_Time (us):10424999.14\n"
    "Batch_size:16\n"
    "FFN_Average_Forward_Time (us):3219485.03\n"
    "FFN_Average_Backward_Time (us):6438970.06\n"
    "Experts:1\n"
    "Seq_len:8192\n"
    "Embedded_dim:4096\n"
    "Device:TPU v5p\n"
    "Dtype:bfloat16\n"
    "Bytes_per_element:2.0\n";

TEST(stats_keyed_parse) {
  ModelStats st = parse_model_stats(kStatsText, "llama3_8b_16_bfloat16");
  CHECK_EQ(st.model_size, 8030261248LL);
  CHECK_NEAR(st.fwd_us, 5212499.57, 0.01);
  CHECK_NEAR(st.bwd_us, 10424999.14, 0.01);
  CHECK_EQ(st.batch_size, 16);
  CHECK_EQ(st.seq_len, 8192);
  CHECK_EQ(st.embed_dim, 4096);
  CHECK_EQ(st.dtype, std::string("bfloat16"));
  CHECK_NEAR(st.bytes_per_element, 2.0, 0);
  CHECK_EQ(st.model_bytes(), 16060522496LL);
}

TEST(stats_reordered_and_case_drift) {
  // keyed parsing must survive the drift the reference mis-parses
  // (SURVEY.md §7.4: reordered lines, non_expert_size capitalization)
  std::string reordered =
      "dtype:float8\n"
      "non_expert_size:123\n"
      "Model_Size:1000\n"
      "Average_Backward_Time (us):20.0\n"
      "Average_Forward_Time (us):10.0\n"
      "Batch_size:4\nSeq_len:128\nEmbedded_dim:64\n"
      "Forward_Flops:1\nBackward_Flops:2\n";
  ModelStats st = parse_model_stats(reordered, "t");
  CHECK_EQ(st.non_expert_size, 123);
  CHECK_EQ(st.dtype, std::string("float8"));
  CHECK_NEAR(st.fwd_us, 10.0, 0);
}

TEST(stats_missing_required) {
  CHECK_THROWS(parse_model_stats("Model_Size:10\n", "bad"));
}

TEST(model_card_parse) {
  Json j = Json::parse(R"({"embed_dim": 4096, "num_heads": 32,
    "num_kv_heads": 8, "ff_dim": 14336, "seq_len": 32768,
    "num_encoder_blocks": 0, "num_decoder_blocks": 32,
    "vocab_size": 32000, "gated_mlp": true,
    "moe_params": {"num_experts": 8, "num_experts_per_tok": 2}})");
  ModelCard c = parse_model_card(j, "mixtral_8x7b");
  CHECK_EQ(c.num_layers(), 32);
  CHECK_EQ(c.num_experts, 8);
  CHECK_EQ(c.top_k, 2);
  CHECK_EQ(c.kv_dim(), 1024);  // 4096/32*8
}

TEST(arch_name_stripping) {
  CHECK_EQ(arch_name_from_stats_name("llama3_8b_16_bfloat16"),
           std::string("llama3_8b"));
  CHECK_EQ(arch_name_from_stats_name("vit_h_128_float8"),
           std::string("vit_h"));
}

// ----------------------------------------------------------- schedule
TEST(bucket_split) {
  auto b = split_buckets(10, 3);
  CHECK_EQ(b.size(), std::size_t{3});
  CHECK_EQ(b[0], 4);
  CHECK_EQ(b[1], 3);
  CHECK_EQ(b[2], 3);
  i64 total = 0;
  for (i64 x : split_buckets(8030261248LL, 7)) total += x;
  CHECK_EQ(total, 8030261248LL);
  CHECK_THROWS(split_buckets(10, 0));
}

TEST(fsdp_padding_and_replicas) {
  ModelStats st = parse_model_stats(kStatsText, "llama3_8b_16_bfloat16");
  auto f = fsdp_schedule(st, 8, 8, 4);
  CHECK_EQ(f.num_replicas, 2);
  CHECK_EQ(f.sharding_factor, 4);
  CHECK(f.shard_size * 4 >= f.unit_sizes[0]);  // padded
  CHECK_EQ(f.padded_unit_size(), f.shard_size * 4);
  CHECK_THROWS(fsdp_schedule(st, 8, 6, 4));  // 6 % 4 != 0
}

TEST(grid3d_coords_colors) {
  Grid3D g{2, 4, 2};  // dp=2 pp=4 tp=2, world 16
  CHECK_EQ(g.world_size(), 16);
  // tp fastest-varying (hybrid_3d.cpp:283-285)
  auto c = g.coords(13);  // 13 = dp1, (13/2)%4 = 2, tp 1
  CHECK_EQ(c.dp_id, 1);
  CHECK_EQ(c.pp_id, 2);
  CHECK_EQ(c.tp_id, 1);
  CHECK_EQ(g.rank(1, 2, 1), 13);
  // all ranks in one tp group share dp_id,pp_id
  for (i64 r1 = 0; r1 < 16; ++r1)
    for (i64 r2 = 0; r2 < 16; ++r2)
      if (g.tp_color(r1) == g.tp_color(r2)) {
        CHECK_EQ(g.coords(r1).dp_id, g.coords(r2).dp_id);
        CHECK_EQ(g.coords(r1).pp_id, g.coords(r2).pp_id);
      }
}

TEST(pipeline_schedule_math) {
  ModelStats st = parse_model_stats(kStatsText, "llama3_8b_16_bfloat16");
  ModelCard card;
  card.embed_dim = 4096;
  card.num_heads = 32;
  card.seq_len = 8192;
  card.num_decoder_blocks = 32;
  auto p = pipeline_schedule(st, card, 4, 8, 1, 2);
  CHECK_EQ(p.layers_per_stage, 8);
  // pipe msg = seq*embed*samples_per_mb = 8192*4096*2
  CHECK_EQ(p.pipe_msg_elems, 8192LL * 4096 * 2);
  CHECK_EQ(p.tp_msg_elems, p.pipe_msg_elems / 2);
  CHECK_EQ(p.dp_sync_elems, st.model_size / 8);
  CHECK_NEAR(p.fwd_us_per_stage_mb, st.fwd_us / (4 * 8 * 2), 0.01);
  CHECK_THROWS(pipeline_schedule(st, card, 5, 8));   // 32 % 5
  CHECK_THROWS(pipeline_schedule(st, card, 4, 3));   // 16 % 3
}

TEST(moe_schedule_math) {
  std::string moe_stats =
      "Forward_Flops:1\nBackward_Flops:2\nModel_Size:46702792704\n"
      "Non_Expert_size:1605654528\n"
      "Average_Forward_Time (us):1000.0\nAverage_Backward_Time (us):2000.0\n"
      "Batch_size:16\nSeq_len:32768\nEmbedded_dim:4096\nDtype:bfloat16\n"
      "Bytes_per_element:2.0\n";
  ModelStats st = parse_model_stats(moe_stats, "mixtral_8x7b_16_bfloat16");
  ModelCard card;
  card.embed_dim = 4096;
  card.seq_len = 32768;
  card.num_decoder_blocks = 32;
  card.num_experts = 8;
  card.top_k = 2;
  auto m = moe_schedule(st, card, 4, 8, 4);
  // tokens/mb = 2*32768; a2a = tokens*topk*embed/shards
  CHECK_EQ(m.a2a_elems, 2LL * 32768 * 2 * 4096 / 4);
  CHECK_EQ(m.a2a_per_direction, 2 * 8);
  CHECK_EQ(m.nonexpert_sync_elems, 1605654528LL / 4);
  CHECK_EQ(m.expert_sync_elems, (46702792704LL - 1605654528LL) / (4 * 4));
  CHECK_THROWS(moe_schedule(st, card, 4, 8, 3));  // 8 % 3
}

TEST(sequence_schedule_math) {
  ModelStats st = parse_model_stats(kStatsText, "llama3_8b_16_bfloat16");
  ModelCard card;
  card.embed_dim = 4096;
  card.num_heads = 32;
  card.num_kv_heads = 8;
  card.seq_len = 8192;
  card.num_decoder_blocks = 32;
  auto s = sequence_schedule(st, card, 4);
  CHECK_EQ(s.seq_per_rank, 2048);
  CHECK_EQ(s.num_ring_hops, 3);
  CHECK_EQ(s.kv_block_elems, 2LL * 16 * 2048 * 1024);
  CHECK_EQ(s.a2a_elems, 16LL * 2048 * 4096);
  CHECK_THROWS(sequence_schedule(st, card, 3));
}

// -------------------------------------------------------------- dtypes
TEST(bf16_roundtrip) {
  CHECK_NEAR(bf16_to_f32(f32_to_bf16(1.0f)), 1.0, 0);
  CHECK_NEAR(bf16_to_f32(f32_to_bf16(-2.5f)), -2.5, 0);
  // bf16 represents small integers exactly
  for (float v : {0.0f, 1.0f, 2.0f, 128.0f, 256.0f})
    CHECK_NEAR(bf16_to_f32(f32_to_bf16(v)), v, 0);
}

TEST(f8_roundtrip) {
  for (float v : {0.0f, 0.5f, 1.0f, -1.0f, 2.0f, 8.0f, -16.0f})
    CHECK_NEAR(f8e4m3_to_f32(f32_to_f8e4m3(v)), v, 0);
  CHECK_NEAR(f8e4m3_to_f32(f32_to_f8e4m3(1000.0f)), 448.0, 0);  // clamp
}

TEST(json_copy_is_deep) {
  Json global = Json::object();
  global["model"] = "a";
  Json rec = Json::object();
  rec["global"] = global;          // copy
  global["model"] = "b";           // mutate original
  CHECK_EQ(rec.at("global").at("model").as_string(), std::string("a"));
  Json arr = Json::array();
  arr.push_back(1);
  Json arr2 = arr;
  arr2.push_back(2);
  CHECK_EQ(arr.items().size(), std::size_t{1});
}

TEST(bf16_nan_stays_nan) {
  std::uint32_t payload_nan = 0x7F800001;  // NaN with low-bits payload
  float f;
  std::memcpy(&f, &payload_nan, 4);
  float back = bf16_to_f32(f32_to_bf16(f));
  CHECK(back != back);  // still NaN, not Inf
}

TEST(tensor_zero_init) {
  Tensor t(1024, DType::BF16);
  CHECK_EQ(t.bytes(), std::size_t{2048});
  for (int i = 0; i < 1024; i += 97) CHECK_NEAR(t.get(i), 0.0, 0);
  t.set(5, 3.5f);
  CHECK_NEAR(t.get(5), 3.5, 0);
}
