// wldio — native ingest (data-loader) for weightedld.
//
// Counterpart of the reference's native readers: the Rust
// implementation keeps its FASTA reader and site-major store in native code
// (rust/weighted_ld/src/lib.rs:277-307, :158-275); this library plays that
// role here.  It parses FASTA alignments and multi-sample VCFs straight from
// an mmap'd file into caller-allocated int8 code matrices (the layout the
// device pipeline uploads), with OpenMP across sequences/records.
//
// Semantics are byte-for-byte identical to the pure-Python parsers in
// weightedld/io/{fasta,vcf}.py (which remain as the fallback path and the
// parity oracle in tests/test_native_io.py), including error messages — the
// Python wrappers re-raise them as the same exception types.
//
// C API (ctypes-friendly): every reader is a pair of calls around an opaque
// handle — `open` scans once and reports dimensions, `fill` writes into
// buffers the caller sized from those dimensions, `close` unmaps.  All
// functions return 0 on success; on failure the error message is written to
// the caller's buffer.
//
// Known divergence from the Python readers: whitespace handling is ASCII
// (space, \t\r\n\v\f).  The Python VCF reader, operating on decoded str,
// also strips Unicode whitespace (e.g. U+00A0) when filtering blank lines —
// inputs where that matters are treated as data here and fail parsing
// loudly rather than silently diverging.

#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // memmem
#endif

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

constexpr int8_t kGap = 4;      // '-' / missing genotype
constexpr int8_t kUnknown = 5;  // ambiguous / unrecognised

// Byte -> symbol code LUT (parity: WeightedLD.py:34-40 via core/encode.py).
struct Lut {
  int8_t t[256];
  Lut() {
    memset(t, kUnknown, sizeof(t));
    t[(unsigned char)'a'] = t[(unsigned char)'A'] = 0;
    t[(unsigned char)'c'] = t[(unsigned char)'C'] = 1;
    t[(unsigned char)'g'] = t[(unsigned char)'G'] = 2;
    t[(unsigned char)'t'] = t[(unsigned char)'T'] = 3;
    t[(unsigned char)'-'] = kGap;
  }
};
const Lut kLut;

inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

void set_err(char* err, int64_t cap, const std::string& msg) {
  if (err && cap > 0) snprintf(err, (size_t)cap, "%s", msg.c_str());
}

// Length of a Unicode-whitespace codepoint (UTF-8) starting at d[b], or 0.
// Mirrors str.strip()'s whitespace set (the Python reader strips FASTA
// names *after* decoding): ASCII ws + 1C-1F, U+0085, U+00A0, U+1680,
// U+2000-200A, U+2028/29/2F, U+205F, U+3000.
size_t uws_len_at(const char* d, size_t b, size_t e) {
  unsigned char c0 = (unsigned char)d[b];
  if (is_ws((char)c0) || (c0 >= 0x1c && c0 <= 0x1f)) return 1;
  if (e - b >= 2 && c0 == 0xC2) {
    unsigned char c1 = (unsigned char)d[b + 1];
    if (c1 == 0x85 || c1 == 0xA0) return 2;
  }
  if (e - b >= 3) {
    unsigned char c1 = (unsigned char)d[b + 1], c2 = (unsigned char)d[b + 2];
    if (c0 == 0xE1 && c1 == 0x9A && c2 == 0x80) return 3;
    if (c0 == 0xE2 && c1 == 0x80 &&
        ((c2 >= 0x80 && c2 <= 0x8A) || c2 == 0xA8 || c2 == 0xA9 || c2 == 0xAF))
      return 3;
    if (c0 == 0xE2 && c1 == 0x81 && c2 == 0x9F) return 3;
    if (c0 == 0xE3 && c1 == 0x80 && c2 == 0x80) return 3;
  }
  return 0;
}

// Trim Unicode whitespace (as UTF-8 byte sequences) from both ends of
// d[b, e).
void trim_unicode_ws(const char* d, size_t* b, size_t* e) {
  for (size_t n; *b < *e && (n = uws_len_at(d, *b, *e)) != 0;) *b += n;
  while (*b < *e) {
    bool trimmed = false;
    for (size_t len = 1; len <= 3 && len <= *e - *b; ++len) {
      if (uws_len_at(d, *e - len, *e) == len) {
        *e -= len;
        trimmed = true;
        break;
      }
    }
    if (!trimmed) break;
  }
}

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path, std::string* err) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      *err = std::string(path) + ": cannot open";
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      *err = std::string(path) + ": cannot stat";
      return false;
    }
    size = (size_t)st.st_size;
    if (size == 0) {
      data = nullptr;  // empty file: valid map of nothing
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      *err = std::string(path) + ": mmap failed";
      return false;
    }
    data = (const char*)p;
    return true;
  }

  void release() {
    if (data) munmap((void*)data, size);
    if (fd >= 0) ::close(fd);
    data = nullptr;
    size = 0;
    fd = -1;
  }

  ~MappedFile() { release(); }
};

struct Span {
  size_t off;
  size_t len;
};

// Input view: the mmap'd file, or (for gzip inputs, magic 1f 8b) an owned
// buffer holding the inflated stream.  Gives both readers transparent
// .fasta.gz / .vcf.gz support, mirroring the Python fallback readers.
struct InputView {
  MappedFile map;
  std::vector<char> owned;
  const char* data = nullptr;
  size_t size = 0;

  bool open(const char* path, std::string* err) {
    if (!map.open(path, err)) return false;
    data = map.data;
    size = map.size;
    if (size >= 2 && (unsigned char)data[0] == 0x1f &&
        (unsigned char)data[1] == 0x8b) {
      return inflate_gzip(path, err);
    }
    return true;
  }

  // Inflate a (possibly multi-member) gzip stream.  BGZF files — the
  // standard bgzip/bcftools .vcf.gz — are concatenations of small gzip
  // members, so after each Z_STREAM_END we reset and continue while the
  // remaining input starts with the gzip magic (the Python gzip module's
  // behavior); anything else left over is trailing garbage and an error.
  // Input is fed in <=1 GiB slices (zlib's avail_in is 32-bit).
  bool inflate_gzip(const char* path, std::string* err) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {  // gzip wrapper
      *err = std::string(path) + ": zlib init failed";
      return false;
    }
    const char* in = data;
    size_t in_left = size;
    std::vector<char> out;
    out.resize(std::max<size_t>(size * 4, 1 << 20));
    size_t produced = 0;
    while (true) {
      if (produced == out.size()) out.resize(out.size() * 2);
      if (zs.avail_in == 0 && in_left > 0) {
        uInt take = (uInt)std::min<size_t>(in_left, 1u << 30);
        zs.next_in = (Bytef*)in;
        zs.avail_in = take;
        in += take;
        in_left -= take;
      }
      zs.next_out = (Bytef*)(out.data() + produced);
      zs.avail_out = (uInt)std::min<size_t>(out.size() - produced, 1u << 30);
      size_t before_out = zs.total_out;
      int rc = inflate(&zs, Z_NO_FLUSH);
      produced += zs.total_out - before_out;
      if (rc == Z_STREAM_END) {
        size_t rest = (size_t)zs.avail_in + in_left;
        if (rest == 0) break;  // clean end of the last member
        const char* next = in - zs.avail_in;
        if (rest >= 2 && (unsigned char)next[0] == 0x1f &&
            (unsigned char)next[1] == 0x8b) {
          // Next gzip member (BGZF / concatenated .gz): keep going.
          uInt take = (uInt)std::min<size_t>(rest, 1u << 30);
          zs.next_in = (Bytef*)next;
          zs.avail_in = take;
          in = next + take;
          in_left = rest - take;
          if (inflateReset(&zs) != Z_OK) {
            inflateEnd(&zs);
            *err = std::string(path) + ": zlib reset failed";
            return false;
          }
          continue;  // `produced` carries across members (delta-tracked)
        }
        inflateEnd(&zs);
        *err = std::string(path) +
               ": trailing garbage after gzip stream (corrupt file?)";
        return false;
      }
      if (rc != Z_OK) {
        inflateEnd(&zs);
        *err = std::string(path) + ": corrupt gzip stream";
        return false;
      }
      if (zs.avail_in == 0 && in_left == 0 && zs.avail_out != 0) {
        inflateEnd(&zs);
        *err = std::string(path) + ": truncated gzip stream";
        return false;
      }
    }
    inflateEnd(&zs);
    out.resize(produced);
    owned = std::move(out);
    data = owned.data();
    size = owned.size();
    map.release();  // the compressed mapping is dead once inflated
    return true;
  }
};

// ---------------------------------------------------------------------------
// FASTA
// ---------------------------------------------------------------------------

struct FastaHandle {
  InputView map;
  std::vector<std::vector<Span>> records;  // per sequence: trimmed data lines
  std::string names_joined;                // '\n'-separated header names
  int64_t n_seqs = 0;
  int64_t n_sites = 0;
};

// Scan lines; semantics of io/fasta.py:read_fasta_with_names — strip each
// line, skip blanks, '>' starts a record (name = rest, stripped), data lines
// append to the current record; data before the first header is an error.
bool fasta_scan(FastaHandle* h, const char* path, std::string* err) {
  const char* d = h->map.data;
  const size_t sz = h->map.size;
  size_t pos = 0;
  bool first_name = true;
  while (pos < sz) {
    const char* nl = (const char*)memchr(d + pos, '\n', sz - pos);
    size_t end = nl ? (size_t)(nl - d) : sz;
    size_t b = pos, e = end;
    while (b < e && is_ws(d[b])) ++b;
    while (e > b && is_ws(d[e - 1])) --e;
    if (b < e) {
      if (d[b] == '>') {
        size_t nb = b + 1, ne = e;
        trim_unicode_ws(d, &nb, &ne);  // Python strips names after decode
        if (!first_name) h->names_joined.push_back('\n');
        first_name = false;
        h->names_joined.append(d + nb, ne - nb);
        h->records.emplace_back();
      } else {
        if (h->records.empty()) {
          *err = std::string(path) + ": sequence data before first '>' header";
          return false;
        }
        h->records.back().push_back(Span{b, e - b});
      }
    }
    pos = nl ? end + 1 : sz;
  }
  if (h->records.empty()) {
    *err = std::string(path) + ": no sequences found";
    return false;
  }
  h->n_seqs = (int64_t)h->records.size();
  auto rec_len = [&](size_t r) {
    size_t n = 0;
    for (const Span& s : h->records[r]) n += s.len;
    return n;
  };
  const size_t expected = rec_len(0);
  for (size_t r = 1; r < h->records.size(); ++r) {
    size_t n = rec_len(r);
    if (n != expected) {
      // Message parity with core/encode.py:encode_alignment.
      *err = "ragged alignment: sequence " + std::to_string(r) +
             " has length " + std::to_string(n) + ", expected " +
             std::to_string(expected);
      return false;
    }
  }
  h->n_sites = (int64_t)expected;
  return true;
}

// ---------------------------------------------------------------------------
// VCF
// ---------------------------------------------------------------------------

struct VcfHandle {
  InputView map;
  std::string path;
  std::vector<Span> lines;       // data record lines (blank-filtered)
  std::vector<int64_t> linenos;  // 1-based file line numbers (for errors)
  int64_t n_sites = 0;
  int64_t n_haps = 0;
};

// Parse the allele token s[b,e).  Parity with io/vcf.py:_parse_allele:
// empty or "." -> 4 (missing); otherwise must be an int; >5 rejected.
// Error messages match the Python reader exactly (no path prefix).
bool parse_allele(const char* s, size_t b, size_t e, int8_t* out,
                  std::string* err) {
  if (b == e || (e - b == 1 && s[b] == '.')) {
    *out = kGap;
    return true;
  }
  // int() parity: optional sign, digits, surrounding whitespace tolerated.
  size_t p = b, q = e;
  while (p < q && is_ws(s[p])) ++p;
  while (q > p && is_ws(s[q - 1])) --q;
  bool neg = false;
  if (p < q && (s[p] == '+' || s[p] == '-')) {
    neg = (s[p] == '-');
    ++p;
  }
  if (p == q) {
    *err = "bad allele '" + std::string(s + b, e - b) + "'";
    return false;
  }
  int64_t v = 0;
  bool prev_digit = false;
  for (; p < q; ++p) {
    if (s[p] == '_') {
      // CPython int(): underscores allowed only between digits.
      if (!prev_digit || p + 1 >= q || s[p + 1] < '0' || s[p + 1] > '9') {
        *err = "bad allele '" + std::string(s + b, e - b) + "'";
        return false;
      }
      prev_digit = false;
      continue;
    }
    if (s[p] < '0' || s[p] > '9') {
      *err = "bad allele '" + std::string(s + b, e - b) + "'";
      return false;
    }
    prev_digit = true;
    // Saturate instead of overflowing; anything > 5 is rejected below and
    // the value is only used in the message (exact up to 10^18).
    if (v < 1000000000000000000LL) v = v * 10 + (s[p] - '0');
  }
  if (neg) v = -v;
  if (v > 5 || v < 0) {
    // 0..5 only: negatives would truncate through int8 into arbitrary
    // codes; matches the Python reader's guard (io/vcf.py:_parse_allele).
    *err = "allele index " + std::to_string(v) +
           " exceeds the supported alphabet (ALT1..ALT3 map to codes 1..3; "
           "ALT4/ALT5 alias the missing/ambiguous codes 4/5 for reference "
           "parity; ALT6+ is unsupported)";
    return false;
  }
  *out = (int8_t)v;
  return true;
}

// Parse one record line.  When `out` is null only counts haplotypes (used by
// open to learn n_haps from the first record).  Semantics parity with
// io/vcf.py:read_vcf general path: fields are GT[:subfields]; 'a|b' splits
// into two haploids; any 'a/b' becomes two missing (WeightedLD.py:355);
// otherwise a single haploid allele.
bool parse_vcf_line(const char* s, size_t len, int64_t lineno,
                    const std::string& path, int8_t* out,
                    int64_t n_haps_expected, int64_t* n_haps_out,
                    int64_t* pos_out, std::string* err) {
  // Locate the first 9 tab-separated columns; GT region is the remainder.
  size_t col_start[10];
  col_start[0] = 0;
  int tabs = 0;
  for (size_t p = 0; p < len && tabs < 9; ++p) {
    if (s[p] == '\t') {
      ++tabs;
      col_start[tabs] = p + 1;
    }
  }
  if (tabs < 9) {
    *err = path + ":" + std::to_string(lineno) + ": fewer than 10 columns";
    return false;
  }
  // POS = column 1, with CPython int() semantics: optional sign,
  // surrounding whitespace, and its exact error message on bad input.
  {
    size_t b = col_start[1], e = col_start[2] - 1;
    size_t p = b, q = e;
    while (p < q && is_ws(s[p])) ++p;
    while (q > p && is_ws(s[q - 1])) --q;
    bool neg = false;
    if (p < q && (s[p] == '+' || s[p] == '-')) {
      neg = (s[p] == '-');
      ++p;
    }
    int64_t v = 0;
    bool any = false, overflow = false, prev_digit = false;
    for (; p < q; ++p) {
      if (s[p] == '_') {  // CPython int(): underscores between digits only
        if (!prev_digit || p + 1 >= q || s[p + 1] < '0' || s[p + 1] > '9') {
          any = false;
          break;
        }
        prev_digit = false;
        continue;
      }
      if (s[p] < '0' || s[p] > '9') {
        any = false;
        break;
      }
      if (v > (INT64_MAX - 9) / 10) overflow = true;
      if (!overflow) v = v * 10 + (s[p] - '0');
      any = true;
      prev_digit = true;
    }
    if (!any) {
      *err = "invalid literal for int() with base 10: '" +
             std::string(s + b, e - b) + "'";
      return false;
    }
    if (overflow) {  // numpy int64 conversion would raise OverflowError
      *err = path + ":" + std::to_string(lineno) + ": POS '" +
             std::string(s + b, e - b) + "' overflows int64";
      return false;
    }
    *pos_out = neg ? -v : v;
  }

  int64_t k = 0;  // haplotypes seen (counts past capacity for diagnostics)
  size_t f = col_start[9];
  while (f <= len) {
    size_t fe = f;
    while (fe < len && s[fe] != '\t') ++fe;
    // GT = field up to the first ':'.
    size_t ge = f;
    while (ge < fe && s[ge] != ':') ++ge;
    // First '|' anywhere in the GT wins (Python checks '|' containment
    // before '/'); otherwise any '/' means unphased -> both missing.
    size_t bar = (size_t)-1, slash = (size_t)-1;
    for (size_t q = f; q < ge; ++q) {
      if (s[q] == '|') {
        bar = q;
        break;
      }
      if (slash == (size_t)-1 && s[q] == '/') slash = q;
    }
    int8_t a, b2;
    if (bar != (size_t)-1) {
      if (!parse_allele(s, f, bar, &a, err)) return false;
      if (!parse_allele(s, bar + 1, ge, &b2, err)) return false;
      if (out && k + 2 <= n_haps_expected) {
        out[k] = a;
        out[k + 1] = b2;
      }
      k += 2;
    } else if (slash != (size_t)-1) {
      if (out && k + 2 <= n_haps_expected) {
        out[k] = kGap;
        out[k + 1] = kGap;
      }
      k += 2;
    } else {
      if (!parse_allele(s, f, ge, &a, err)) return false;
      if (out && k + 1 <= n_haps_expected) out[k] = a;
      k += 1;
    }
    if (fe == len) break;
    f = fe + 1;
  }
  if (n_haps_expected >= 0 && k != n_haps_expected) {
    *err = path + ":" + std::to_string(lineno) +
           ": inconsistent haplotype count (" + std::to_string(k) + " vs " +
           std::to_string(n_haps_expected) + ")";
    return false;
  }
  if (n_haps_out) *n_haps_out = k;
  return true;
}

bool vcf_scan(VcfHandle* h, std::string* err) {
  const char* d = h->map.data;
  const size_t sz = h->map.size;

  // Split into lines like Python's text-mode read().split("\n"): universal
  // newlines first translate "\r\n" and "\r" to "\n", then every '\n'
  // terminates a line; a final element after the last terminator exists
  // even when empty.
  std::vector<Span> all;
  size_t pos = 0;
  while (true) {
    size_t e = pos;
    while (e < sz && d[e] != '\n' && d[e] != '\r') ++e;
    all.push_back(Span{pos, e - pos});
    if (e == sz) break;
    pos = (d[e] == '\r' && e + 1 < sz && d[e + 1] == '\n') ? e + 2 : e + 1;
  }

  // Header: first line containing "#CHROM".
  size_t header_idx = (size_t)-1;
  for (size_t i = 0; i < all.size(); ++i) {
    const Span& s = all[i];
    if (s.len >= 6 && memmem(d + s.off, s.len, "#CHROM", 6) != nullptr) {
      header_idx = i;
      break;
    }
  }
  if (header_idx == (size_t)-1) {
    *err = h->path + ": no #CHROM header line found";
    return false;
  }

  // Data lines; reference parity quirk: unconditionally drop the final line
  // (WeightedLD.py:365), then drop blanks.
  size_t lo = header_idx + 1, hi = all.size();
  if (hi > lo) --hi;
  int64_t filtered_no = (int64_t)header_idx + 2;  // Python numbers errors by
  for (size_t i = lo; i < hi; ++i) {              // filtered-list position
    const Span& s = all[i];
    bool blank = true;
    for (size_t q = 0; q < s.len && blank; ++q)
      if (!is_ws(d[s.off + q])) blank = false;
    if (!blank) {
      h->lines.push_back(s);
      h->linenos.push_back(filtered_no++);
    }
  }
  if (h->lines.empty()) {
    *err = h->path + ": no variant records";
    return false;
  }
  // Multi-sample check: first data line must have > 12 tab columns.
  {
    const Span& s = h->lines[0];
    size_t ncols = 1;
    for (size_t q = 0; q < s.len; ++q)
      if (d[s.off + q] == '\t') ++ncols;
    if (ncols <= 12) {
      *err = h->path +
             ": too few sample columns — is this a multi-sample VCF?";
      return false;
    }
  }
  // Learn n_haps from the first record.
  int64_t pos_dummy = 0;
  if (!parse_vcf_line(d + h->lines[0].off, h->lines[0].len, h->linenos[0],
                      h->path, nullptr, -1, &h->n_haps, &pos_dummy, err))
    return false;
  h->n_sites = (int64_t)h->lines.size();
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// TSV record formatting
// ---------------------------------------------------------------------------
//
// Native counterpart of the Rust reference's pair/weights TSV writers
// (rust/weighted_ld/src/main.rs:70-119), with the *Python* reference's value
// formatting: each cell is CPython's `repr(round(x, ndigits))`
// (WeightedLD.py:282-284).  Reproduced in two steps:
//   1. round(x, n): fixed-point decimal rounding of the exact binary value
//      (glibc printf is correctly rounded, half-even on exact ties — the
//      same result as CPython's dtoa-based double_round), re-parsed to the
//      nearest double.
//   2. repr: shortest round-trip digits (std::to_chars, same Ryu/Grisu
//      family as CPython), rendered with CPython's format_float_short rule:
//      fixed notation iff -4 < decpt <= 16, else scientific with a signed,
//      >=2-digit exponent; integral values keep a trailing ".0".
// Parity is asserted value-for-value in tests/test_native_io.py.

#include <charconv>
#include <cmath>
#include <cstdlib>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Render a decimal significand (digit chars, no dot) with CPython's
// format_float_short rule: value = 0.DIGITS * 10^decpt; fixed notation iff
// -4 < decpt <= 16, else scientific with signed >=2-digit exponent;
// integral values keep a trailing ".0".  Returns chars written.
size_t render_py_float(bool neg, const char* digits, size_t nd, int decpt,
                       char* out) {
  char* w = out;
  if (neg) *w++ = '-';
  if (-4 < decpt && decpt <= 16) {
    if (decpt <= 0) {
      *w++ = '0';
      *w++ = '.';
      for (int i = 0; i < -decpt; ++i) *w++ = '0';
      memcpy(w, digits, nd);
      w += nd;
    } else if ((size_t)decpt >= nd) {
      memcpy(w, digits, nd);
      w += nd;
      for (size_t i = nd; i < (size_t)decpt; ++i) *w++ = '0';
      *w++ = '.';
      *w++ = '0';
    } else {
      memcpy(w, digits, (size_t)decpt);
      w += decpt;
      *w++ = '.';
      memcpy(w, digits + decpt, nd - (size_t)decpt);
      w += nd - (size_t)decpt;
    }
  } else {
    *w++ = digits[0];
    if (nd > 1) {
      *w++ = '.';
      memcpy(w, digits + 1, nd - 1);
      w += nd - 1;
    }
    *w++ = 'e';
    int e = decpt - 1;
    *w++ = e < 0 ? '-' : '+';
    if (e < 0) e = -e;
    char eb[16];
    int en = snprintf(eb, sizeof(eb), "%02d", e);
    memcpy(w, eb, (size_t)en);
    w += en;
  }
  return (size_t)(w - out);
}

// Append CPython repr(v): shortest round-trip digits (to_chars, same
// Ryu/Grisu family as CPython's dtoa) + the rendering rule above.
size_t py_repr(double v, char* out) {
  char* w = out;
  if (std::isnan(v)) {
    memcpy(w, "nan", 3);
    return 3;
  }
  if (std::isinf(v)) {
    if (v < 0) *w++ = '-';
    memcpy(w, "inf", 3);
    return (size_t)(w - out) + 3;
  }
  bool neg = std::signbit(v);
  if (neg) v = -v;
  char sci[64];
  auto res = std::to_chars(sci, sci + sizeof(sci) - 1, v,
                           std::chars_format::scientific);
  *res.ptr = '\0';  // strtol below must not read past the written chars
  char digits[32];
  size_t nd = 0;
  int exp10 = 0;
  {
    char* p = sci;
    for (; p < res.ptr && *p != 'e'; ++p)
      if (*p != '.') digits[nd++] = *p;
    if (p < res.ptr) exp10 = (int)strtol(p + 1, nullptr, 10);
  }
  return render_py_float(neg, digits, nd, exp10 + 1, out);
}

// repr(round(v, ndigits)), slow path: fixed-precision std::to_chars is the
// rounding engine (correctly rounded, half-even on exact decimal ties —
// the standard specifies printf-"%f"-in-the-C-locale semantics — matching
// CPython's dtoa-based double_round).  NOT snprintf/strtod: those honor
// LC_NUMERIC, and a host process that set a comma-decimal locale would
// silently corrupt the TSV.  After stripping trailing zeros, a significand
// of <= 15 digits IS the shortest round-trip repr of the rounded double:
// any shorter decimal in that range is further than half an ULP away, so
// only then do we need the from_chars + to_chars pass.
size_t py_round_repr_slow(double v, int ndigits, char* out) {
  if (!std::isfinite(v)) return py_repr(v, out);
  char fixed[512];
  auto fres = std::to_chars(fixed, fixed + sizeof(fixed) - 1, v,
                            std::chars_format::fixed, ndigits);
  *fres.ptr = '\0';
  const char* p = fixed;
  bool neg = (*p == '-');
  if (neg) ++p;
  const char* dot = strchr(p, '.');
  char digits[448];  // up to 309 integer + (ndigits<=100) fractional digits
  size_t nd = 0;
  int decpt;
  const char* q = p;
  while (*q == '0') ++q;  // leading zeros of the integer part
  if (dot) {
    if (q < dot) {
      decpt = (int)(dot - q);
      for (const char* r = q; r < dot; ++r) digits[nd++] = *r;
      for (const char* r = dot + 1; *r; ++r) digits[nd++] = *r;
    } else {
      const char* r = dot + 1;
      int lead = 0;
      while (*r == '0') {
        ++r;
        ++lead;
      }
      decpt = -lead;
      for (; *r; ++r) digits[nd++] = *r;
    }
  } else {  // ndigits == 0: no decimal point in the fixed form
    decpt = (int)strlen(q);
    for (const char* r = q; *r; ++r) digits[nd++] = *r;
  }
  while (nd > 0 && digits[nd - 1] == '0') --nd;
  if (nd == 0) {  // rounded to (signed) zero
    digits[0] = '0';
    nd = 1;
    decpt = 1;
  }
  if (nd <= 15) return render_py_float(neg, digits, nd, decpt, out);
  double rv = 0.0;
  std::from_chars(fixed, fres.ptr, rv);  // locale-independent strtod
  return py_repr(rv, out);
}

// repr(round(v, ndigits)), fast path: round the *shortest-repr digits*
// directly (to_chars is ~50ns; snprintf+strtod are ~1us).  The shortest
// digits DS are the closest decimal of their quantum q to the exact binary
// value, so cutting DS at the n-decimal grid gives the same answer as
// cutting the exact expansion whenever the remainder is not within
// ulp/2 <= 12q of the grid midpoint — near-ties (and magnitudes where the
// grid outruns the significand, |decpt|+n > 15) defer to the slow path's
// exact glibc rounding.  Parity is asserted over millions of adversarial
// values (ties, dyadics, +/-0, boundaries) in tests/test_native_io.py.
size_t py_round_repr(double v, int ndigits, char* out) {
  if (!std::isfinite(v) || ndigits > 14) return py_round_repr_slow(v, ndigits, out);
  bool neg = std::signbit(v);
  double a = neg ? -v : v;
  char zero = '0';
  if (a == 0.0) return render_py_float(neg, &zero, 1, 1, out);
  char sci[64];
  auto res = std::to_chars(sci, sci + sizeof(sci) - 1, a,
                           std::chars_format::scientific);
  *res.ptr = '\0';
  char ds[32];
  int64_t nd = 0;
  int exp10 = 0;
  {
    char* p = sci;
    for (; p < res.ptr && *p != 'e'; ++p)
      if (*p != '.') ds[nd++] = *p;
    if (p < res.ptr) exp10 = (int)strtol(p + 1, nullptr, 10);
  }
  const int decpt = exp10 + 1;
  const int64_t k = (int64_t)decpt + ndigits;  // digits of DS to keep
  if (k > 15) return py_round_repr_slow(v, ndigits, out);
  if (k >= nd) return render_py_float(neg, ds, (size_t)nd, decpt, out);
  if (k < 0) return render_py_float(neg, &zero, 1, 1, out);
  // Remainder vs the grid midpoint, in last-digit quanta.
  int64_t r = 0, half = 5;
  for (int64_t i = k; i < nd; ++i) r = r * 10 + (ds[i] - '0');
  for (int64_t i = k + 1; i < nd; ++i) half *= 10;
  const int64_t dist = r > half ? r - half : half - r;
  if (dist <= 12) return py_round_repr_slow(v, ndigits, out);
  char rd[20];
  size_t rn;
  int rdec = decpt;
  if (r < half) {  // round down: keep the first k digits
    if (k == 0) return render_py_float(neg, &zero, 1, 1, out);
    memcpy(rd, ds, (size_t)k);
    rn = (size_t)k;
  } else if (k == 0) {  // round up across the leading digit
    rd[0] = '1';
    rn = 1;
    ++rdec;
  } else {  // round up: increment the kept digit string
    memcpy(rd, ds, (size_t)k);
    rn = (size_t)k;
    int64_t i = k - 1;
    while (i >= 0 && rd[i] == '9') rd[i--] = '0';
    if (i < 0) {  // 99..9 -> 100..0: zeros strip below
      rd[0] = '1';
      rn = 1;
      ++rdec;
    } else {
      ++rd[i];
    }
  }
  while (rn > 0 && rd[rn - 1] == '0') --rn;
  if (rn == 0) {
    rd[0] = '0';
    rn = 1;
    rdec = 1;
  }
  return render_py_float(neg, rd, rn, rdec, out);
}

size_t write_i64(int64_t v, char* out) {
  char* end = out + 24;
  auto r = std::to_chars(out, end, v);
  return (size_t)(r.ptr - out);
}

}  // namespace

extern "C" {

// Format n pair records as TSV rows "posa\tposb\tD\tD'\tr2\n" into out
// (caller-allocated, out_cap bytes).  Returns bytes written, or -1 if the
// buffer is too small (caller should retry with a bigger one).
int64_t wldio_format_pairs(const int64_t* pos_a, const int64_t* pos_b,
                           const double* d, const double* d_prime,
                           const double* r2, int64_t n, int ndigits,
                           char* out, int64_t out_cap) {
  // Worst case per row: 2x int64 (20) + 3x float (~24 each) + separators.
  const int64_t kMaxRow = 128;
  if (n == 0) return 0;
  // Negative precision is meaningless to %.*f (Python round(x,-n) rounds to
  // tens); >100 would overrun the fixed-format buffer.  Callers fall back
  // to the Python writer outside [0, 100].
  if (ndigits < 0 || ndigits > 100) return -1;
  // Threads format disjoint row ranges at their worst-case offsets inside
  // `out` itself, then ranges are compacted left sequentially.
  if (n * kMaxRow > out_cap) return -1;
  int nth = 1;
#ifdef _OPENMP
  nth = omp_get_max_threads();
#endif
  const int64_t chunk = (n + nth - 1) / nth;
  std::vector<int64_t> lens((size_t)nth, 0);
#pragma omp parallel for schedule(static, 1)
  for (int t = 0; t < nth; ++t) {
    const int64_t lo = (int64_t)t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    char* w = out + lo * kMaxRow;
    const char* base = w;
    for (int64_t i = lo; i < hi; ++i) {
      w += write_i64(pos_a[i], w);
      *w++ = '\t';
      w += write_i64(pos_b[i], w);
      *w++ = '\t';
      w += py_round_repr(d[i], ndigits, w);
      *w++ = '\t';
      w += py_round_repr(d_prime[i], ndigits, w);
      *w++ = '\t';
      w += py_round_repr(r2[i], ndigits, w);
      *w++ = '\n';
    }
    lens[(size_t)t] = w - base;
  }
  int64_t written = lens[0];
  for (int t = 1; t < nth; ++t) {
    memmove(out + written, out + (int64_t)t * chunk * kMaxRow,
            (size_t)lens[(size_t)t]);
    written += lens[(size_t)t];
  }
  return written;
}

// Format per-sequence weights as TSV rows "index\tweight\n".
int64_t wldio_format_weights(const double* weights, int64_t n, int ndigits,
                             char* out, int64_t out_cap) {
  const int64_t kMaxRow = 64;
  if (ndigits < 0 || ndigits > 100) return -1;  // see wldio_format_pairs
  int64_t written = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (written + kMaxRow > out_cap) return -1;
    char* w = out + written;
    w += write_i64(i, w);
    *w++ = '\t';
    w += py_round_repr(weights[i], ndigits, w);
    *w++ = '\n';
    written = w - out;
  }
  return written;
}

}  // extern "C"

extern "C" {

const char* wldio_version() { return "wldio-4"; }

// ---- transpose-pad ---------------------------------------------------------
// [n, s] int8 row-major -> [s_pad, n_pad] row-major TRANSPOSE with the
// padding cells set to `fill` — the host side of the device upload layout
// (pallas_ld.pad_alignment_site_major).  numpy's strided assignment
// (out[:s, :n] = a.T) measured 16 s on the 1 GB pod-scale matrix; this
// blocked OpenMP version runs at memory bandwidth.
void wldio_transpose_pad_i8(const int8_t* src, int64_t n, int64_t s,
                            int8_t* dst, int64_t s_pad, int64_t n_pad,
                            int8_t fill) {
  const int64_t B = 128;
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i0 = 0; i0 < s_pad; i0 += B) {
    const int64_t i1 = std::min(i0 + B, s_pad);
    const int64_t ir = std::min(i1, s);  // rows with real (transposed) data
    for (int64_t j0 = 0; j0 < n; j0 += B) {
      const int64_t j1 = std::min(j0 + B, n);
      for (int64_t i = i0; i < ir; ++i) {
        int8_t* drow = dst + i * n_pad;
        const int8_t* scol = src + i;
        for (int64_t j = j0; j < j1; ++j) drow[j] = scol[j * s];
      }
    }
    for (int64_t i = i0; i < i1; ++i) {
      if (i < s) {
        if (n_pad > n) memset(dst + i * n_pad + n, fill, (size_t)(n_pad - n));
      } else {
        memset(dst + i * n_pad, fill, (size_t)n_pad);
      }
    }
  }
}

// ---- FASTA ----------------------------------------------------------------

void* wldio_fasta_open(const char* path, int64_t* n_seqs, int64_t* n_sites,
                       int64_t* names_len, char* err, int64_t err_cap) {
  auto* h = new FastaHandle;
  std::string e;
  if (!h->map.open(path, &e) || !fasta_scan(h, path, &e)) {
    set_err(err, err_cap, e);
    delete h;
    return nullptr;
  }
  *n_seqs = h->n_seqs;
  *n_sites = h->n_sites;
  *names_len = (int64_t)h->names_joined.size();
  return h;
}

int wldio_fasta_fill(void* handle, int8_t* out, char* names_out) {
  auto* h = (FastaHandle*)handle;
  const char* d = h->map.data;
  const int64_t n_sites = h->n_sites;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < h->n_seqs; ++r) {
    int8_t* row = out + r * n_sites;
    size_t o = 0;
    for (const Span& s : h->records[(size_t)r])
      for (size_t j = 0; j < s.len; ++j)
        row[o++] = kLut.t[(unsigned char)d[s.off + j]];
  }
  if (names_out)
    memcpy(names_out, h->names_joined.data(), h->names_joined.size());
  return 0;
}

void wldio_fasta_close(void* handle) { delete (FastaHandle*)handle; }

// ---- VCF ------------------------------------------------------------------

void* wldio_vcf_open(const char* path, int64_t* n_sites, int64_t* n_haps,
                     char* err, int64_t err_cap) {
  auto* h = new VcfHandle;
  h->path = path;
  std::string e;
  if (!h->map.open(path, &e) || !vcf_scan(h, &e)) {
    set_err(err, err_cap, e);
    delete h;
    return nullptr;
  }
  *n_sites = h->n_sites;
  *n_haps = h->n_haps;
  return h;
}

// out: [n_sites, n_haps] site-major int8; positions: [n_sites] int64.
int wldio_vcf_fill(void* handle, int8_t* out, int64_t* positions, char* err,
                   int64_t err_cap) {
  auto* h = (VcfHandle*)handle;
  const char* d = h->map.data;
  const int64_t n = h->n_sites;
  const int64_t n_haps = h->n_haps;
  std::atomic<int64_t> first_bad{INT64_MAX};  // earliest failing record
  std::string first_err;
  std::mutex m;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n; ++i) {
    if (i > first_bad.load(std::memory_order_relaxed)) continue;
    const Span& s = h->lines[(size_t)i];
    std::string e;
    int64_t k = 0;
    if (!parse_vcf_line(d + s.off, s.len, h->linenos[(size_t)i], h->path,
                        out + i * n_haps, n_haps, &k, &positions[i], &e)) {
      std::lock_guard<std::mutex> g(m);
      // Keep the earliest record's error (deterministic, matching the
      // sequential Python reader).
      if (i < first_bad.load()) {
        first_bad.store(i);
        first_err = e;
      }
    }
  }
  if (first_bad.load() != INT64_MAX) {
    set_err(err, err_cap, first_err);
    return 1;
  }
  return 0;
}

void wldio_vcf_close(void* handle) { delete (VcfHandle*)handle; }

}  // extern "C"
