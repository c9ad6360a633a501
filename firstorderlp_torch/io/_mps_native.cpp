// Native MPS/QPS tokenizer (free format).
//
// The hot loop of host-side model ingest: section scan, name->index
// resolution, float parsing, COO assembly. Semantics are an exact
// mirror of the pure-Python reader in mps.py (itself a re-derivation
// of the behavior of QPSReader.jl as used by the reference at
// src/quadratic_programming_io.jl:147-197); mps.py remains the source
// of truth, and tests/test_torch_io_native.py asserts field-exact
// parity between the two on every fixture.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC, driven by io/native.py into
// firstorderlp_torch/_build/<source hash>/. Exposed via a C API
// consumed with ctypes -- no pybind11.
//
// Scope: free-format files only (fixed-format column slicing stays in
// Python; it is used for a handful of legacy Netlib instances where
// parse time is irrelevant). Gzip decompression happens in Python
// (zlib is C-speed there already); this code receives the decompressed
// text buffer.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// Open-addressing string_view -> int64 map (FNV-1a, linear probing).
// std::unordered_map's node allocations and pointer chains are the
// parse bottleneck at ~1M name lookups per million nonzeros.
class NameMap {
 public:
  NameMap() { rehash(1 << 12); }

  static uint64_t hash(std::string_view s) {
    uint64_t h = 1469598103934665603ull;
    for (char ch : s) {
      h ^= static_cast<unsigned char>(ch);
      h *= 1099511628211ull;
    }
    return h | 1;  // 0 marks an empty slot
  }

  int64_t* find(std::string_view key, uint64_t h) {
    size_t i = h & mask_;
    while (hashes_[i]) {
      if (hashes_[i] == h && keys_[i] == key) return &vals_[i];
      i = (i + 1) & mask_;
    }
    return nullptr;
  }
  int64_t* find(std::string_view key) { return find(key, hash(key)); }

  void insert(std::string_view key, int64_t val) {
    if ((size_ + 1) * 10 >= capacity() * 7) rehash(capacity() * 2);
    const uint64_t h = hash(key);
    size_t i = h & mask_;
    while (hashes_[i]) i = (i + 1) & mask_;
    hashes_[i] = h;
    keys_[i] = key;
    vals_[i] = val;
    ++size_;
  }

  size_t size() const { return size_; }

 private:
  size_t capacity() const { return hashes_.size(); }

  void rehash(size_t cap) {
    std::vector<uint64_t> oh = std::move(hashes_);
    std::vector<std::string_view> ok = std::move(keys_);
    std::vector<int64_t> ov = std::move(vals_);
    hashes_.assign(cap, 0);
    keys_.assign(cap, {});
    vals_.assign(cap, 0);
    mask_ = cap - 1;
    for (size_t i = 0; i < oh.size(); ++i) {
      if (!oh[i]) continue;
      size_t j = oh[i] & mask_;
      while (hashes_[j]) j = (j + 1) & mask_;
      hashes_[j] = oh[i];
      keys_[j] = ok[i];
      vals_[j] = ov[i];
    }
  }

  std::vector<uint64_t> hashes_;
  std::vector<std::string_view> keys_;
  std::vector<int64_t> vals_;
  size_t size_ = 0;
  size_t mask_ = 0;
};

struct BoundEvent {
  int type;
  std::string_view col;  // resolved in finalize(): a column may be
                         // introduced by a later section (e.g. QUADOBJ)
  double value;
};

enum BoundType {
  B_LO = 0,
  B_UP,
  B_FX,
  B_FR,
  B_MI,
  B_PL,
  B_BV,
  B_LI,
  B_UI,
  B_UNKNOWN
};

struct Parse {
  std::string error;

  std::string name;
  std::string objsense = "notset";
  double obj_rhs = 0.0;

  std::vector<std::string_view> row_order;   // non-N rows in order
  std::vector<char> row_types;               // 'E','L','G' per row
  NameMap row_index;
  std::vector<std::string_view> varnames;
  NameMap col_index;

  std::vector<int64_t> c_cols;  // objective entries, accumulated later
  std::vector<double> c_vals;

  std::vector<int64_t> arows, acols;
  std::vector<double> avals;
  std::vector<int64_t> qrows, qcols;
  std::vector<double> qvals;

  std::vector<double> rhs;        // per row, last write wins
  std::vector<uint8_t> rhs_set;
  std::vector<int64_t> range_rows;
  std::vector<double> range_vals;
  std::vector<BoundEvent> bounds;

  // Final dense vectors, filled by finalize().
  std::vector<double> c, lvar, uvar, lcon, ucon;

  std::string varnames_blob, connames_blob;
};

bool is_space(char ch) { return ch == ' ' || ch == '\t' || ch == '\r'; }

// Splits [p, end) into whitespace-delimited tokens.
void split(const char* p, const char* end, std::vector<std::string_view>* out) {
  out->clear();
  while (p < end) {
    while (p < end && is_space(*p)) ++p;
    const char* tok = p;
    while (p < end && !is_space(*p)) ++p;
    if (p > tok) out->emplace_back(tok, static_cast<size_t>(p - tok));
  }
}

bool parse_double(std::string_view s, double* out) {
  // Tokens are slices of the file buffer, not NUL-terminated; strtod
  // needs termination, so bounce through a small stack buffer.
  char buf[64];
  if (s.size() >= sizeof(buf)) return false;
  std::memcpy(buf, s.data(), s.size());
  buf[s.size()] = '\0';
  char* tail = nullptr;
  *out = std::strtod(buf, &tail);
  return tail == buf + s.size();
}

std::string upper(std::string_view s) {
  std::string r(s);
  for (char& ch : r) ch = static_cast<char>(std::toupper(ch));
  return r;
}

int bound_type(const std::string& t) {
  if (t == "LO") return B_LO;
  if (t == "UP") return B_UP;
  if (t == "FX") return B_FX;
  if (t == "FR") return B_FR;
  if (t == "MI") return B_MI;
  if (t == "PL") return B_PL;
  if (t == "BV") return B_BV;
  if (t == "LI") return B_LI;
  if (t == "UI") return B_UI;
  return B_UNKNOWN;
}

enum Section {
  S_NONE = 0,
  S_NAME,
  S_OBJSENSE,
  S_ROWS,
  S_COLUMNS,
  S_RHS,
  S_RANGES,
  S_BOUNDS,
  S_QUADOBJ,
  S_QMATRIX,
  S_QSECTION,
  S_ENDATA,
  S_UNKNOWN
};

Section section_of(const std::string& head) {
  if (head == "NAME") return S_NAME;
  if (head == "OBJSENSE") return S_OBJSENSE;
  if (head == "ROWS") return S_ROWS;
  if (head == "COLUMNS") return S_COLUMNS;
  if (head == "RHS") return S_RHS;
  if (head == "RANGES") return S_RANGES;
  if (head == "BOUNDS") return S_BOUNDS;
  if (head == "QUADOBJ") return S_QUADOBJ;
  if (head == "QMATRIX") return S_QMATRIX;
  if (head == "QSECTION") return S_QSECTION;
  if (head == "ENDATA") return S_ENDATA;
  return S_UNKNOWN;
}

int64_t get_col(Parse* ps, std::string_view name) {
  int64_t* v = ps->col_index.find(name);
  if (v) return *v;
  int64_t idx = static_cast<int64_t>(ps->varnames.size());
  ps->col_index.insert(name, idx);
  ps->varnames.push_back(name);
  return idx;
}

void fail(Parse* ps, const std::string& msg, const char* line_begin,
          const char* line_end) {
  ps->error = msg + ": " +
              std::string(line_begin, static_cast<size_t>(line_end - line_begin));
}

void finalize(Parse* ps) {
  const int64_t ncon = static_cast<int64_t>(ps->row_order.size());
  const int64_t nvar = static_cast<int64_t>(ps->varnames.size());
  const double inf = HUGE_VAL;

  ps->c.assign(static_cast<size_t>(nvar), 0.0);
  for (size_t k = 0; k < ps->c_cols.size(); ++k)
    ps->c[static_cast<size_t>(ps->c_cols[k])] += ps->c_vals[k];

  ps->lcon.assign(static_cast<size_t>(ncon), -inf);
  ps->ucon.assign(static_cast<size_t>(ncon), inf);
  for (int64_t i = 0; i < ncon; ++i) {
    const char t = ps->row_types[static_cast<size_t>(i)];
    const double b =
        ps->rhs_set[static_cast<size_t>(i)] ? ps->rhs[static_cast<size_t>(i)] : 0.0;
    if (t == 'E') {
      ps->lcon[static_cast<size_t>(i)] = b;
      ps->ucon[static_cast<size_t>(i)] = b;
    } else if (t == 'L') {
      ps->ucon[static_cast<size_t>(i)] = b;
    } else {  // 'G'
      ps->lcon[static_cast<size_t>(i)] = b;
    }
  }

  // RANGES: last write per row wins (dict semantics in mps.py), applied
  // against the final rhs values.
  std::unordered_map<int64_t, double> last_range;
  for (size_t k = 0; k < ps->range_rows.size(); ++k)
    last_range[ps->range_rows[k]] = ps->range_vals[k];
  for (const auto& kv : last_range) {
    const int64_t i = kv.first;
    const double r = kv.second;
    const char t = ps->row_types[static_cast<size_t>(i)];
    const double b =
        ps->rhs_set[static_cast<size_t>(i)] ? ps->rhs[static_cast<size_t>(i)] : 0.0;
    if (t == 'E') {
      if (r >= 0) {
        ps->lcon[static_cast<size_t>(i)] = b;
        ps->ucon[static_cast<size_t>(i)] = b + r;
      } else {
        ps->lcon[static_cast<size_t>(i)] = b + r;
        ps->ucon[static_cast<size_t>(i)] = b;
      }
    } else if (t == 'L') {
      ps->lcon[static_cast<size_t>(i)] = b - std::abs(r);
      ps->ucon[static_cast<size_t>(i)] = b;
    } else {  // 'G'
      ps->lcon[static_cast<size_t>(i)] = b;
      ps->ucon[static_cast<size_t>(i)] = b + std::abs(r);
    }
  }

  ps->lvar.assign(static_cast<size_t>(nvar), 0.0);
  ps->uvar.assign(static_cast<size_t>(nvar), inf);
  std::vector<uint8_t> lower_set(static_cast<size_t>(nvar), 0);
  for (const BoundEvent& e : ps->bounds) {
    int64_t* v = ps->col_index.find(e.col);
    if (!v) {
      ps->error = "Unknown column '" + std::string(e.col) + "' in BOUNDS";
      return;
    }
    const size_t j = static_cast<size_t>(*v);
    switch (e.type) {
      case B_LO:
      case B_LI:
        ps->lvar[j] = e.value;
        lower_set[j] = 1;
        break;
      case B_UP:
      case B_UI:
        ps->uvar[j] = e.value;
        // Classic MPS convention: negative upper bound with no explicit
        // lower bound implies lower bound -inf (mps.py:309-312).
        if (e.value < 0 && !lower_set[j]) ps->lvar[j] = -inf;
        break;
      case B_FX:
        ps->lvar[j] = e.value;
        ps->uvar[j] = e.value;
        lower_set[j] = 1;
        break;
      case B_FR:
        ps->lvar[j] = -inf;
        ps->uvar[j] = inf;
        break;
      case B_MI:
        ps->lvar[j] = -inf;
        lower_set[j] = 1;
        break;
      case B_PL:
        ps->uvar[j] = inf;
        break;
      case B_BV:
        ps->lvar[j] = 0.0;
        ps->uvar[j] = 1.0;
        lower_set[j] = 1;
        break;
      default:
        break;  // unreachable; rejected at parse time
    }
  }

  ps->varnames_blob.clear();
  for (size_t k = 0; k < ps->varnames.size(); ++k) {
    if (k) ps->varnames_blob.push_back('\n');
    ps->varnames_blob.append(ps->varnames[k]);
  }
  ps->connames_blob.clear();
  for (size_t k = 0; k < ps->row_order.size(); ++k) {
    if (k) ps->connames_blob.push_back('\n');
    ps->connames_blob.append(ps->row_order[k]);
  }
}

}  // namespace

extern "C" {

// Parses the decompressed MPS text [buf, buf+len). The buffer must stay
// alive until folp_mps_destroy (string_views point into it; the Python
// wrapper keeps the bytes object referenced for the handle's lifetime).
void* folp_mps_parse(const char* buf, int64_t len) {
  Parse* ps = new Parse();
  const char* p = buf;
  const char* end = buf + len;

  Section section = S_NONE;
  bool pending_objsense = false;
  // COLUMNS lists entries grouped by column; cache the last name to
  // skip the hash lookup on runs.
  std::string_view last_col_name;
  int64_t last_col_idx = -1;
  bool have_obj_row = false;
  std::string_view obj_row;
  std::vector<std::string_view> tok;
  tok.reserve(16);

  while (p < end && ps->error.empty()) {
    const char* line = p;
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    p = nl ? nl + 1 : end;

    // Skip blank lines and '*' comments (mps.py:_lines).
    const char* q = line;
    while (q < line_end && is_space(*q)) ++q;
    if (q == line_end) continue;
    if (*q == '*') continue;

    const bool starts_flush = !is_space(line[0]);
    split(line, line_end, &tok);

    if (starts_flush) {
      const std::string head = upper(tok[0]);
      const Section sec = section_of(head);
      if (sec == S_UNKNOWN) {
        fail(ps, "Unknown section header", line, line_end);
        break;
      }
      section = sec;
      if (sec == S_NAME) {
        ps->name = tok.size() > 1 ? std::string(tok[1]) : "";
      } else if (sec == S_OBJSENSE) {
        if (tok.size() > 1) {
          std::string v(tok[1].substr(0, 3));
          for (char& ch : v) ch = static_cast<char>(std::tolower(ch));
          ps->objsense = v;
          pending_objsense = false;
        } else {
          pending_objsense = true;
        }
      } else if (sec == S_ENDATA) {
        break;
      }
      continue;
    }

    if (section == S_OBJSENSE && pending_objsense) {
      std::string v(tok[0].substr(0, 3));
      for (char& ch : v) ch = static_cast<char>(std::tolower(ch));
      ps->objsense = v;
      pending_objsense = false;
      continue;
    }

    switch (section) {
      case S_ROWS: {
        if (tok.size() < 2) {
          fail(ps, "Bad ROWS line", line, line_end);
          break;
        }
        const std::string rtype = upper(tok[0]);
        const std::string_view rname = tok[1];
        if (rtype == "N") {
          if (!have_obj_row) {
            obj_row = rname;
            have_obj_row = true;
          }
          break;  // extra N rows are free rows, ignored
        }
        if (rtype != "E" && rtype != "L" && rtype != "G") {
          fail(ps, "Unknown row type '" + rtype + "' in", line, line_end);
          break;
        }
        if (ps->row_index.find(rname)) {
          fail(ps, "Duplicate row name in", line, line_end);
          break;
        }
        ps->row_index.insert(rname,
                             static_cast<int64_t>(ps->row_order.size()));
        ps->row_order.push_back(rname);
        ps->row_types.push_back(rtype[0]);
        ps->rhs.push_back(0.0);
        ps->rhs_set.push_back(0);
        break;
      }

      case S_COLUMNS: {
        bool marker = false;
        if (tok.size() >= 3) {
          for (const std::string_view& t : tok)
            if (t == "'MARKER'") {
              marker = true;
              break;
            }
        }
        if (marker) break;
        if (tok.size() < 1 || tok.size() % 2 == 0) {
          fail(ps, "Bad COLUMNS line", line, line_end);
          break;
        }
        int64_t col;
        if (last_col_idx >= 0 && tok[0] == last_col_name) {
          col = last_col_idx;
        } else {
          col = get_col(ps, tok[0]);
          last_col_name = tok[0];
          last_col_idx = col;
        }
        for (size_t i = 1; i + 1 < tok.size(); i += 2) {
          const std::string_view rname = tok[i];
          double val;
          if (!parse_double(tok[i + 1], &val)) {
            fail(ps, "Bad numeric value in COLUMNS", line, line_end);
            break;
          }
          if (have_obj_row && rname == obj_row) {
            ps->c_cols.push_back(col);
            ps->c_vals.push_back(val);
          } else {
            int64_t* v = ps->row_index.find(rname);
            if (!v) {
              fail(ps, "Unknown row in COLUMNS", line, line_end);
              break;
            }
            ps->arows.push_back(*v);
            ps->acols.push_back(col);
            ps->avals.push_back(val);
          }
        }
        break;
      }

      case S_RHS: {
        if (tok.size() % 2 == 0) {
          fail(ps, "Bad RHS line", line, line_end);
          break;
        }
        for (size_t i = 1; i < tok.size(); i += 2) {
          const std::string_view rname = tok[i];
          double val;
          if (!parse_double(tok[i + 1], &val)) {
            fail(ps, "Bad numeric value in RHS", line, line_end);
            break;
          }
          if (have_obj_row && rname == obj_row) {
            ps->obj_rhs = val;
          } else {
            int64_t* v = ps->row_index.find(rname);
            if (!v) {
              fail(ps, "Unknown row in RHS", line, line_end);
              break;
            }
            ps->rhs[static_cast<size_t>(*v)] = val;
            ps->rhs_set[static_cast<size_t>(*v)] = 1;
          }
        }
        break;
      }

      case S_RANGES: {
        if (tok.size() % 2 == 0) {
          fail(ps, "Bad RANGES line", line, line_end);
          break;
        }
        for (size_t i = 1; i < tok.size(); i += 2) {
          int64_t* v = ps->row_index.find(tok[i]);
          if (!v) {
            fail(ps, "Unknown row in RANGES", line, line_end);
            break;
          }
          double val;
          if (!parse_double(tok[i + 1], &val)) {
            fail(ps, "Bad numeric value in RANGES", line, line_end);
            break;
          }
          ps->range_rows.push_back(*v);
          ps->range_vals.push_back(val);
        }
        break;
      }

      case S_BOUNDS: {
        const std::string btype_s = upper(tok[0]);
        const int bt = bound_type(btype_s);
        if (bt == B_UNKNOWN) {
          fail(ps, "Unknown bound type in", line, line_end);
          break;
        }
        const bool valueless =
            (bt == B_FR || bt == B_MI || bt == B_PL || bt == B_BV);
        if (tok.size() < (valueless ? 3u : 4u)) {
          fail(ps, "Bad BOUNDS line", line, line_end);
          break;
        }
        double val = 0.0;
        if (!valueless && !parse_double(tok[3], &val)) {
          fail(ps, "Bad numeric value in BOUNDS", line, line_end);
          break;
        }
        ps->bounds.push_back(BoundEvent{bt, tok[2], val});
        break;
      }

      case S_QUADOBJ:
      case S_QMATRIX:
      case S_QSECTION: {
        if (tok.size() < 3) {
          fail(ps, "Bad quadratic objective line", line, line_end);
          break;
        }
        const int64_t i = get_col(ps, tok[0]);
        const int64_t j = get_col(ps, tok[1]);
        double val;
        if (!parse_double(tok[2], &val)) {
          fail(ps, "Bad numeric value in quadratic objective", line, line_end);
          break;
        }
        if (section == S_QMATRIX && i < j) break;  // keep lower triangle
        ps->qrows.push_back(i);
        ps->qcols.push_back(j);
        ps->qvals.push_back(val);
        break;
      }

      case S_NAME:
      case S_OBJSENSE:
        break;

      default:
        fail(ps, "Data line outside any section", line, line_end);
        break;
    }
  }

  if (ps->error.empty()) finalize(ps);
  return ps;
}

const char* folp_mps_error(void* h) {
  return static_cast<Parse*>(h)->error.c_str();
}
int64_t folp_mps_nvar(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->varnames.size());
}
int64_t folp_mps_ncon(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->row_order.size());
}
int64_t folp_mps_annz(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->avals.size());
}
int64_t folp_mps_qnnz(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->qvals.size());
}
double folp_mps_c0(void* h) { return -static_cast<Parse*>(h)->obj_rhs; }
const char* folp_mps_name(void* h) {
  return static_cast<Parse*>(h)->name.c_str();
}
const char* folp_mps_objsense(void* h) {
  return static_cast<Parse*>(h)->objsense.c_str();
}

void folp_mps_copy(void* h, double* c, double* lvar, double* uvar,
                   double* lcon, double* ucon, int64_t* arows, int64_t* acols,
                   double* avals, int64_t* qrows, int64_t* qcols,
                   double* qvals) {
  Parse* ps = static_cast<Parse*>(h);
  auto cpy = [](auto* dst, const auto& src) {
    if (!src.empty())
      std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cpy(c, ps->c);
  cpy(lvar, ps->lvar);
  cpy(uvar, ps->uvar);
  cpy(lcon, ps->lcon);
  cpy(ucon, ps->ucon);
  cpy(arows, ps->arows);
  cpy(acols, ps->acols);
  cpy(avals, ps->avals);
  cpy(qrows, ps->qrows);
  cpy(qcols, ps->qcols);
  cpy(qvals, ps->qvals);
}

int64_t folp_mps_varnames_len(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->varnames_blob.size());
}
void folp_mps_varnames(void* h, char* out) {
  const std::string& b = static_cast<Parse*>(h)->varnames_blob;
  std::memcpy(out, b.data(), b.size());
}
int64_t folp_mps_connames_len(void* h) {
  return static_cast<int64_t>(static_cast<Parse*>(h)->connames_blob.size());
}
void folp_mps_connames(void* h, char* out) {
  const std::string& b = static_cast<Parse*>(h)->connames_blob;
  std::memcpy(out, b.data(), b.size());
}

void folp_mps_destroy(void* h) { delete static_cast<Parse*>(h); }

}  // extern "C"
