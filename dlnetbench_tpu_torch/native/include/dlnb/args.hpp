// Declarative CLI parsing — the easyargs equivalent.
//
// The reference's binaries declare a macro table of required/optional args
// before including ccutils/easyargs.hpp (reference
// cpp/data_parallel/dp.cpp:108-124).  The rebuild uses a small runtime
// registry instead of macros: same capability (required/optional
// string/int/double/bool flags, auto --help), no preprocessor tricks.
#pragma once

#include <cstdlib>
#include <iostream>
#include <stdexcept>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace dlnb {

class Args {
 public:
  explicit Args(std::string prog_desc) : desc_(std::move(prog_desc)) {}

  Args& required_str(const std::string& name, const std::string& help) {
    specs_.push_back({name, Kind::Str, true, "", help});
    return *this;
  }
  Args& optional_str(const std::string& name, std::string dflt,
                     const std::string& help) {
    specs_.push_back({name, Kind::Str, false, std::move(dflt), help});
    return *this;
  }
  Args& required_int(const std::string& name, const std::string& help) {
    specs_.push_back({name, Kind::Int, true, "", help});
    return *this;
  }
  Args& optional_int(const std::string& name, long long dflt,
                     const std::string& help) {
    specs_.push_back({name, Kind::Int, false, std::to_string(dflt), help});
    return *this;
  }
  Args& optional_double(const std::string& name, double dflt,
                        const std::string& help) {
    std::ostringstream os;
    os << dflt;
    specs_.push_back({name, Kind::Double, false, os.str(), help});
    return *this;
  }
  Args& flag(const std::string& name, const std::string& help) {
    specs_.push_back({name, Kind::Flag, false, "0", help});
    return *this;
  }

  // Parse --name value / --name=value / bare --flag.  Exits with usage on
  // error or --help (the easyargs behavior).
  void parse(int argc, char** argv) {
    prog_ = argc > 0 ? argv[0] : "proxy";
    for (const auto& s : specs_)
      if (!s.required) values_[s.name] = s.dflt;
    for (int i = 1; i < argc; ++i) {
      std::string tok = argv[i];
      if (tok == "--help" || tok == "-h") usage_and_exit(0);
      if (tok.rfind("--", 0) != 0) die("unexpected positional '" + tok + "'");
      std::string name = tok.substr(2), val;
      auto eq = name.find('=');
      bool has_val = false;
      if (eq != std::string::npos) {
        val = name.substr(eq + 1);
        name = name.substr(0, eq);
        has_val = true;
      }
      const Spec* spec = find(name);
      if (!spec) die("unknown option --" + name);
      if (spec->kind == Kind::Flag) {
        values_[name] = has_val ? val : "1";
      } else {
        if (!has_val) {
          if (i + 1 >= argc) die("--" + name + " needs a value");
          val = argv[++i];
        }
        validate(*spec, val);
        values_[name] = val;
      }
    }
    for (const auto& s : specs_)
      if (s.required && values_.find(s.name) == values_.end())
        die("missing required --" + s.name);
  }

  std::string str(const std::string& name) const { return values_.at(name); }
  long long integer(const std::string& name) const {
    return std::stoll(values_.at(name));
  }
  double number(const std::string& name) const {
    return std::stod(values_.at(name));
  }
  bool flag_set(const std::string& name) const {
    const std::string& v = values_.at(name);
    return v == "1" || v == "true";
  }

 private:
  enum class Kind { Str, Int, Double, Flag };
  struct Spec {
    std::string name;
    Kind kind;
    bool required;
    std::string dflt;
    std::string help;
  };

  // numeric values are checked at parse time so a bad value dies with
  // usage instead of throwing from integer()/number() later
  void validate(const Spec& spec, const std::string& val) const {
    try {
      std::size_t used = 0;
      if (spec.kind == Kind::Int) {
        (void)std::stoll(val, &used);
      } else if (spec.kind == Kind::Double) {
        (void)std::stod(val, &used);
      } else {
        return;
      }
      if (used != val.size()) throw std::invalid_argument(val);
    } catch (const std::exception&) {
      die("--" + spec.name + " expects a " +
          (spec.kind == Kind::Int ? "integer" : "number") + ", got '" + val +
          "'");
    }
  }

  const Spec* find(const std::string& name) const {
    for (const auto& s : specs_)
      if (s.name == name) return &s;
    return nullptr;
  }

  [[noreturn]] void die(const std::string& msg) const {
    std::cerr << prog_ << ": " << msg << "\n";
    usage_and_exit(2);
  }

  [[noreturn]] void usage_and_exit(int code) const {
    std::ostream& os = code == 0 ? std::cout : std::cerr;
    os << desc_ << "\nusage: " << prog_;
    for (const auto& s : specs_)
      os << (s.required ? " --" + s.name + " <v>"
                        : " [--" + s.name +
                              (s.kind == Kind::Flag ? "]" : " <v>]"));
    os << "\n";
    for (const auto& s : specs_)
      os << "  --" << s.name << (s.required ? "  (required)  " : "  ")
         << s.help
         << (s.required || s.dflt.empty() ? "" : "  [default " + s.dflt + "]")
         << "\n";
    std::exit(code);
  }

  std::string desc_, prog_;
  std::vector<Spec> specs_;
  std::map<std::string, std::string> values_;
};

}  // namespace dlnb
