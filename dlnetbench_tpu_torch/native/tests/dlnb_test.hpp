// Minimal check/assert test harness for the native tier's unit tests.
// Each test binary registers TESTs and main() runs them all, printing
// one PASS/FAIL line per test — exit code is the failure count (ctest
// integration needs nothing more).
#pragma once

#include <cmath>
#include <functional>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

namespace dlnb_test {

struct Case {
  std::string name;
  std::function<void()> fn;
};

inline std::vector<Case>& registry() {
  static std::vector<Case> r;
  return r;
}

struct Registrar {
  Registrar(std::string name, std::function<void()> fn) {
    registry().push_back({std::move(name), std::move(fn)});
  }
};

struct Failure {
  std::string msg;
};

#define TEST(name)                                                     \
  static void test_##name();                                           \
  static ::dlnb_test::Registrar reg_##name{#name, test_##name};        \
  static void test_##name()

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::ostringstream os_;                                          \
      os_ << __FILE__ << ":" << __LINE__ << ": CHECK failed: " #cond;  \
      throw ::dlnb_test::Failure{os_.str()};                           \
    }                                                                  \
  } while (0)

#define CHECK_EQ(a, b)                                                 \
  do {                                                                 \
    auto va_ = (a);                                                    \
    auto vb_ = (b);                                                    \
    if (!(va_ == vb_)) {                                               \
      std::ostringstream os_;                                          \
      os_ << __FILE__ << ":" << __LINE__ << ": CHECK_EQ failed: " #a   \
          << " (" << va_ << ") != " #b << " (" << vb_ << ")";          \
      throw ::dlnb_test::Failure{os_.str()};                           \
    }                                                                  \
  } while (0)

#define CHECK_NEAR(a, b, tol)                                          \
  do {                                                                 \
    double va_ = (a);                                                  \
    double vb_ = (b);                                                  \
    if (std::fabs(va_ - vb_) > (tol)) {                                \
      std::ostringstream os_;                                          \
      os_ << __FILE__ << ":" << __LINE__ << ": CHECK_NEAR failed: " #a \
          << " (" << va_ << ") vs " #b << " (" << vb_ << ") tol "      \
          << (tol);                                                    \
      throw ::dlnb_test::Failure{os_.str()};                           \
    }                                                                  \
  } while (0)

#define CHECK_THROWS(expr)                                             \
  do {                                                                 \
    bool threw_ = false;                                               \
    try {                                                              \
      (void)(expr);                                                    \
    } catch (const ::dlnb_test::Failure&) {                            \
      throw;                                                           \
    } catch (...) {                                                    \
      threw_ = true;                                                   \
    }                                                                  \
    if (!threw_) {                                                     \
      std::ostringstream os_;                                          \
      os_ << __FILE__ << ":" << __LINE__                               \
          << ": CHECK_THROWS failed: " #expr " did not throw";         \
      throw ::dlnb_test::Failure{os_.str()};                           \
    }                                                                  \
  } while (0)

inline int run_all() {
  int failures = 0;
  for (const auto& c : registry()) {
    try {
      c.fn();
      std::cout << "PASS " << c.name << "\n";
    } catch (const Failure& f) {
      std::cout << "FAIL " << c.name << ": " << f.msg << "\n";
      ++failures;
    } catch (const std::exception& e) {
      std::cout << "FAIL " << c.name << ": unexpected exception: " << e.what()
                << "\n";
      ++failures;
    }
  }
  std::cout << registry().size() - failures << "/" << registry().size()
            << " tests passed\n";
  return failures;
}

}  // namespace dlnb_test

int main() { return ::dlnb_test::run_all(); }
