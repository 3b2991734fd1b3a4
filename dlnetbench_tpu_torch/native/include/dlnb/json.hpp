// Minimal JSON value: parse + serialize.
//
// The reference links nlohmann/json for model-card parsing
// (reference cpp/utils.hpp:17); this rebuild ships a small self-contained
// reader/writer so the native tier has zero external dependencies.  It
// covers the full JSON grammar the framework needs: objects, arrays,
// strings (with escapes), numbers (kept as int64 when integral so model
// sizes and FLOP counts round-trip exactly), booleans, null.
#pragma once

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace dlnb {

class Json;
using JsonArray = std::vector<Json>;
// std::map keeps key order deterministic for golden-file tests.
using JsonObject = std::map<std::string, Json>;

class Json {
 public:
  enum class Type { Null, Bool, Int, Double, String, Array, Object };

  Json() : type_(Type::Null) {}
  Json(std::nullptr_t) : type_(Type::Null) {}
  Json(bool b) : type_(Type::Bool), bool_(b) {}
  Json(int v) : type_(Type::Int), int_(v) {}
  Json(long v) : type_(Type::Int), int_(v) {}
  Json(long long v) : type_(Type::Int), int_(v) {}
  Json(unsigned long long v) : type_(Type::Int),
                               int_(static_cast<std::int64_t>(v)) {}
  Json(std::size_t v) : type_(Type::Int), int_(static_cast<std::int64_t>(v)) {}
  Json(double v) : type_(Type::Double), dbl_(v) {}
  Json(const char* s) : type_(Type::String), str_(s) {}
  Json(std::string s) : type_(Type::String), str_(std::move(s)) {}
  Json(JsonArray a) : type_(Type::Array),
                      arr_(std::make_shared<JsonArray>(std::move(a))) {}
  Json(JsonObject o) : type_(Type::Object),
                       obj_(std::make_shared<JsonObject>(std::move(o))) {}

  // Value semantics: copying deep-copies containers so a record assembled
  // from shared metadata never aliases it (nlohmann-style behavior).
  Json(const Json& o)
      : type_(o.type_), bool_(o.bool_), int_(o.int_), dbl_(o.dbl_),
        str_(o.str_) {
    if (o.arr_) arr_ = std::make_shared<JsonArray>(*o.arr_);
    if (o.obj_) obj_ = std::make_shared<JsonObject>(*o.obj_);
  }
  Json& operator=(const Json& o) {
    if (this != &o) {
      Json tmp(o);
      *this = std::move(tmp);
    }
    return *this;
  }
  Json(Json&&) = default;
  Json& operator=(Json&&) = default;

  static Json array() { return Json(JsonArray{}); }
  static Json object() { return Json(JsonObject{}); }

  Type type() const { return type_; }
  bool is_null() const { return type_ == Type::Null; }
  bool is_number() const {
    return type_ == Type::Int || type_ == Type::Double;
  }
  bool is_string() const { return type_ == Type::String; }
  bool is_array() const { return type_ == Type::Array; }
  bool is_object() const { return type_ == Type::Object; }

  bool as_bool() const { expect(Type::Bool); return bool_; }
  std::int64_t as_int() const {
    if (type_ == Type::Double) return static_cast<std::int64_t>(dbl_);
    expect(Type::Int);
    return int_;
  }
  double as_double() const {
    if (type_ == Type::Int) return static_cast<double>(int_);
    expect(Type::Double);
    return dbl_;
  }
  const std::string& as_string() const { expect(Type::String); return str_; }

  JsonArray& items() { expect(Type::Array); return *arr_; }
  const JsonArray& items() const { expect(Type::Array); return *arr_; }
  JsonObject& fields() { expect(Type::Object); return *obj_; }
  const JsonObject& fields() const { expect(Type::Object); return *obj_; }

  bool contains(const std::string& key) const {
    return is_object() && obj_->count(key) > 0;
  }
  const Json& at(const std::string& key) const {
    expect(Type::Object);
    auto it = obj_->find(key);
    if (it == obj_->end()) throw std::out_of_range("json: no key '" + key + "'");
    return it->second;
  }
  Json& operator[](const std::string& key) {
    if (type_ == Type::Null) {
      type_ = Type::Object;
      obj_ = std::make_shared<JsonObject>();
    }
    expect(Type::Object);
    return (*obj_)[key];
  }
  void push_back(Json v) {
    if (type_ == Type::Null) {
      type_ = Type::Array;
      arr_ = std::make_shared<JsonArray>();
    }
    expect(Type::Array);
    arr_->push_back(std::move(v));
  }

  // -------------------------------------------------------------- dump
  std::string dump() const {
    std::ostringstream os;
    write(os);
    return os.str();
  }

  void write(std::ostream& os) const {
    switch (type_) {
      case Type::Null: os << "null"; break;
      case Type::Bool: os << (bool_ ? "true" : "false"); break;
      case Type::Int: os << int_; break;
      case Type::Double: write_double(os, dbl_); break;
      case Type::String: write_string(os, str_); break;
      case Type::Array: {
        os << '[';
        bool first = true;
        for (const auto& v : *arr_) {
          if (!first) os << ", ";
          first = false;
          v.write(os);
        }
        os << ']';
        break;
      }
      case Type::Object: {
        os << '{';
        bool first = true;
        for (const auto& [k, v] : *obj_) {
          if (!first) os << ", ";
          first = false;
          write_string(os, k);
          os << ": ";
          v.write(os);
        }
        os << '}';
        break;
      }
    }
  }

  // -------------------------------------------------------------- parse
  static Json parse(const std::string& text) {
    Parser p{text, 0};
    Json v = p.value();
    p.skip_ws();
    if (p.pos != text.size())
      throw std::runtime_error("json: trailing characters at " +
                               std::to_string(p.pos));
    return v;
  }

 private:
  struct Parser {
    const std::string& s;
    std::size_t pos;

    [[noreturn]] void fail(const std::string& what) {
      throw std::runtime_error("json: " + what + " at offset " +
                               std::to_string(pos));
    }
    void skip_ws() {
      while (pos < s.size() && (s[pos] == ' ' || s[pos] == '\t' ||
                                s[pos] == '\n' || s[pos] == '\r'))
        ++pos;
    }
    char peek() {
      if (pos >= s.size()) fail("unexpected end");
      return s[pos];
    }
    char next() {
      char c = peek();
      ++pos;
      return c;
    }
    void expect_lit(const char* lit) {
      for (const char* p = lit; *p; ++p)
        if (pos >= s.size() || s[pos++] != *p) fail("bad literal");
    }

    Json value() {
      skip_ws();
      char c = peek();
      switch (c) {
        case '{': return object();
        case '[': return array();
        case '"': return Json(string());
        case 't': expect_lit("true"); return Json(true);
        case 'f': expect_lit("false"); return Json(false);
        case 'n': expect_lit("null"); return Json(nullptr);
        default: return number();
      }
    }

    Json object() {
      next();  // '{'
      JsonObject out;
      skip_ws();
      if (peek() == '}') { next(); return Json(std::move(out)); }
      while (true) {
        skip_ws();
        std::string key = string();
        skip_ws();
        if (next() != ':') fail("expected ':'");
        out[key] = value();
        skip_ws();
        char c = next();
        if (c == '}') break;
        if (c != ',') fail("expected ',' or '}'");
      }
      return Json(std::move(out));
    }

    Json array() {
      next();  // '['
      JsonArray out;
      skip_ws();
      if (peek() == ']') { next(); return Json(std::move(out)); }
      while (true) {
        out.push_back(value());
        skip_ws();
        char c = next();
        if (c == ']') break;
        if (c != ',') fail("expected ',' or ']'");
      }
      return Json(std::move(out));
    }

    std::string string() {
      if (next() != '"') fail("expected string");
      std::string out;
      while (true) {
        char c = next();
        if (c == '"') break;
        if (c == '\\') {
          char e = next();
          switch (e) {
            case '"': out += '"'; break;
            case '\\': out += '\\'; break;
            case '/': out += '/'; break;
            case 'b': out += '\b'; break;
            case 'f': out += '\f'; break;
            case 'n': out += '\n'; break;
            case 'r': out += '\r'; break;
            case 't': out += '\t'; break;
            case 'u': {
              unsigned cp = 0;
              for (int i = 0; i < 4; ++i) {
                char h = next();
                cp <<= 4;
                if (h >= '0' && h <= '9') cp |= h - '0';
                else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
                else fail("bad \\u escape");
              }
              // UTF-8 encode (BMP only; surrogate pairs unneeded here)
              if (cp < 0x80) {
                out += static_cast<char>(cp);
              } else if (cp < 0x800) {
                out += static_cast<char>(0xC0 | (cp >> 6));
                out += static_cast<char>(0x80 | (cp & 0x3F));
              } else {
                out += static_cast<char>(0xE0 | (cp >> 12));
                out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
                out += static_cast<char>(0x80 | (cp & 0x3F));
              }
              break;
            }
            default: fail("bad escape");
          }
        } else {
          out += c;
        }
      }
      return out;
    }

    Json number() {
      std::size_t start = pos;
      if (peek() == '-') next();
      while (pos < s.size() && std::isdigit(static_cast<unsigned char>(s[pos])))
        ++pos;
      bool integral = true;
      if (pos < s.size() && s[pos] == '.') {
        integral = false;
        ++pos;
        while (pos < s.size() &&
               std::isdigit(static_cast<unsigned char>(s[pos])))
          ++pos;
      }
      if (pos < s.size() && (s[pos] == 'e' || s[pos] == 'E')) {
        integral = false;
        ++pos;
        if (pos < s.size() && (s[pos] == '+' || s[pos] == '-')) ++pos;
        while (pos < s.size() &&
               std::isdigit(static_cast<unsigned char>(s[pos])))
          ++pos;
      }
      std::string tok = s.substr(start, pos - start);
      if (tok.empty() || tok == "-") fail("bad number");
      try {
        if (integral) return Json(static_cast<long long>(std::stoll(tok)));
        return Json(std::stod(tok));
      } catch (const std::exception&) {
        fail("unparseable number '" + tok + "'");
      }
    }
  };

  static void write_string(std::ostream& os, const std::string& s) {
    os << '"';
    for (char c : s) {
      switch (c) {
        case '"': os << "\\\""; break;
        case '\\': os << "\\\\"; break;
        case '\b': os << "\\b"; break;
        case '\f': os << "\\f"; break;
        case '\n': os << "\\n"; break;
        case '\r': os << "\\r"; break;
        case '\t': os << "\\t"; break;
        default:
          if (static_cast<unsigned char>(c) < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof buf, "\\u%04x", c);
            os << buf;
          } else {
            os << c;
          }
      }
    }
    os << '"';
  }

  static void write_double(std::ostream& os, double d) {
    if (std::isnan(d) || std::isinf(d)) { os << "null"; return; }
    char buf[32];
    std::snprintf(buf, sizeof buf, "%.17g", d);
    // trim to shortest round-trip-safe form
    for (int prec = 1; prec < 17; ++prec) {
      char t[32];
      std::snprintf(t, sizeof t, "%.*g", prec, d);
      if (std::stod(t) == d) { std::snprintf(buf, sizeof buf, "%s", t); break; }
    }
    os << buf;
    // ensure it reads back as a double, not an int
    if (!std::strpbrk(buf, ".eE")) os << ".0";
  }

  void expect(Type t) const {
    if (type_ != t) throw std::runtime_error("json: wrong type access");
  }

  Type type_;
  bool bool_ = false;
  std::int64_t int_ = 0;
  double dbl_ = 0.0;
  std::string str_;
  std::shared_ptr<JsonArray> arr_;
  std::shared_ptr<JsonObject> obj_;
};

}  // namespace dlnb
