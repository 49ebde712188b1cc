// Native text-file loader for the data convention.
//
// Reference analog: load_matr / load_vec (src/matr_utils.c:42-83) — the
// reference's IO layer is native C reading whitespace-separated %lf tokens.
// This loader slurps the file and walks it with an exact int64-mantissa
// parser (strtod_l fallback for e-notation / long tokens), bitwise identical
// to numpy's loadtxt — it keeps the reference-faithful --use-files benchmark
// path cheap at full size (10200^2 doubles as %.4f text is ~800 MB).
// chip_smoke.py's section 48 times it against numpy.
//
// Contract (see utils/io.py, _load_values):
//   returns n <= capacity   — number of doubles parsed (EOF reached);
//   returns capacity + 1    — the file holds MORE than `capacity` values
//                             (the extras are not written);
//   returns -1              — file could not be opened/read;
//   returns -3              — malformed content (non-numeric tokens / fused
//                             tokens); caller falls back to numpy so both
//                             paths reject the same files.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <locale.h>
#include <vector>

namespace {

// Exact powers of ten representable as doubles (10^0 .. 10^22).
constexpr double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                             1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                             1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool IsSpace(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Fast correctly-rounded parser for the common fixed-notation case
// (<= 15 significant digits, small exponent): the mantissa accumulates
// exactly in int64 and the single scale by an *exact* power of ten (multiply
// for >=0, divide for <0 — both one IEEE rounding) matches strtod bit for
// bit. Anything outside that envelope (huge digit counts, e-notation with
// large exponents, inf/nan) falls back to strtod.
inline double ParseDouble(const char* p, const char** end) {
  const char* orig = p;  // returned via *end when nothing parses
  while (IsSpace(*p)) ++p;
  const char* start = p;
  bool neg = false;
  if (*p == '+' || *p == '-') neg = (*p++ == '-');

  uint64_t mant = 0;
  int digits = 0, frac = 0;
  for (; *p >= '0' && *p <= '9'; ++p) {
    mant = mant * 10 + static_cast<uint64_t>(*p - '0');
    ++digits;
  }
  if (*p == '.') {
    ++p;
    for (; *p >= '0' && *p <= '9'; ++p) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++digits;
      ++frac;
    }
  }
  if (*p == 'x' || *p == 'X') {
    // C99 hex-float ('0x1p3'): strtod accepts it but numpy rejects it — the
    // two paths must reject identical files, so fail the token here (the
    // caller's trailing-content check then reports the file malformed).
    *end = orig;
    return 0.0;
  }
  if (digits == 0 || digits > 15 || *p == 'e' || *p == 'E' || *p == 'n' ||
      *p == 'N' || *p == 'i' || *p == 'I') {
    // strtod_l with a cached C locale: plain strtod honors LC_NUMERIC, so an
    // embedding app under e.g. de_DE (comma decimal separator) would silently
    // misparse '1.5e3' — the numpy path is locale-independent and this one
    // must match it.
    static locale_t c_locale = newlocale(LC_ALL_MASK, "C", nullptr);
    char* e2 = nullptr;
    double v = strtod_l(start, &e2, c_locale);
    *end = (e2 == start) ? orig : e2;
    return v;
  }
  double v = static_cast<double>(mant);  // exact: mant < 10^15 < 2^53
  if (frac > 0) v /= kPow10[frac];       // exact divisor: one rounding
  *end = p;
  return neg ? -v : v;
}

}  // namespace

extern "C" int64_t matvec_load_text(const char* path, double* out,
                                    int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return -1;
  }
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return -1;
  }
  std::rewind(f);
  // +1 for a NUL terminator so strtod never walks off the buffer.
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  int64_t n = 0;
  // Line-structure tracking: np.loadtxt skips blank lines but rejects ragged
  // ones ("Wrong number of columns at line N"), even when the total element
  // count matches — both parser paths must reject identical files, so the
  // first non-blank line fixes the expected token count and every later
  // non-blank line must match it.
  int64_t tokens_in_line = 0;
  int64_t tokens_per_line = -1;
  auto end_line = [&]() -> bool {  // false => ragged line structure
    if (tokens_in_line == 0) return true;  // blank line: skipped, like numpy
    if (tokens_per_line < 0) {
      tokens_per_line = tokens_in_line;
    } else if (tokens_in_line != tokens_per_line) {
      return false;
    }
    tokens_in_line = 0;
    return true;
  };
  while (n < capacity) {
    while (IsSpace(*p)) {
      if (*p == '\n' && !end_line()) return -3;
      ++p;
    }
    const char* end = nullptr;
    double v = ParseDouble(p, &end);
    if (end == p) break;  // no more parseable tokens
    // Tokens must be whitespace-separated: a fused token like '1.5-2.5'
    // (which numpy rejects) must not silently split into two values.
    if (!IsSpace(*end) && *end != '\0') return -3;
    ++tokens_in_line;
    out[n++] = v;
    p = end;
  }
  // Whatever remains must be pure whitespace (EOF) or, at capacity, more
  // well-formed values (count mismatch). Anything else is malformed.
  while (IsSpace(*p)) {
    if (*p == '\n' && !end_line()) return -3;
    ++p;
  }
  if (*p == '\0') {
    if (!end_line()) return -3;  // final line, no trailing newline
    return n;
  }
  if (n == capacity) {
    const char* end = nullptr;
    (void)ParseDouble(p, &end);
    if (end != p && (IsSpace(*end) || *end == '\0')) return capacity + 1;
  }
  return -3;
}
