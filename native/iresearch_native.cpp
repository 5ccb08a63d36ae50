// Native host components (reference parity: the reference implements its
// whole host side in C++20 — analysis in core/analysis/, Levenshtein in
// core/utils/levenshtein_utils.cpp). This build keeps device work in
// XLA/Pallas and uses this library for the hot host paths:
//   * ASCII word segmentation + case folding (write-path tokenizer,
//     reference: segmentation_token_stream.cpp)
//   * banded batch Damerau-Levenshtein over UTF-32 candidates (fuzzy
//     term expansion, reference: levenshtein_utils.cpp parametric DFA)
//
// Build: `make -C native` -> libiresearch_native.so, loaded via ctypes
// (iresearch_tpu/native.py) with pure-Python fallbacks when absent.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// Term dictionary: term bytes -> dense id, insertion-ordered ids
// (the in-RAM half of the reference's postings hash, core/index/postings
// .hpp:78-125 — open addressing over block_pool slices; here a
// std::unordered_map over an arena).
struct TermDict {
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> terms;  // id -> term

  int32_t add(std::string_view term) {
    auto it = map.find(std::string(term));
    if (it != map.end()) return it->second;
    int32_t id = static_cast<int32_t>(terms.size());
    terms.emplace_back(term);
    map.emplace(terms.back(), id);
    return id;
  }
};

}  // namespace

extern "C" {

void* irs_termdict_new() { return new TermDict(); }

void irs_termdict_free(void* h) { delete static_cast<TermDict*>(h); }

int32_t irs_termdict_size(void* h) {
  return static_cast<int32_t>(static_cast<TermDict*>(h)->terms.size());
}

int32_t irs_termdict_add(void* h, const char* term, int32_t len) {
  return static_cast<TermDict*>(h)->add(std::string_view(term, len));
}

// merge src's terms into dst (one C call per transaction register):
// out_map[src_id] = dst_id for every src term. Returns src size.
// (reference analog: SegmentContext streams merge under the flush
// mutex, index_writer.cpp:732-760 — the remap is the whole merge here)
int32_t irs_termdict_merge(void* dst, void* src, int32_t* out_map) {
  auto* d = static_cast<TermDict*>(dst);
  auto* s = static_cast<TermDict*>(src);
  const int32_t n = static_cast<int32_t>(s->terms.size());
  for (int32_t i = 0; i < n; ++i) out_map[i] = d->add(s->terms[i]);
  return n;
}

// total bytes of all terms (for dump buffer sizing)
int64_t irs_termdict_bytes(void* h) {
  int64_t total = 0;
  for (const auto& t : static_cast<TermDict*>(h)->terms) total += t.size();
  return total;
}

// dump terms in id order: blob gets concatenated bytes, offsets[i] is the
// start of term i (offsets has size+1 entries)
void irs_termdict_dump(void* h, char* blob, int64_t* offsets) {
  auto* d = static_cast<TermDict*>(h);
  int64_t off = 0;
  int64_t i = 0;
  for (const auto& t : d->terms) {
    offsets[i++] = off;
    std::memcpy(blob + off, t.data(), t.size());
    off += t.size();
  }
  offsets[i] = off;
}

// Tokenize ASCII text AND map each token to its term id in one pass — the
// whole write-path inner loop (analyzer::next + postings::emplace,
// reference: field_data.cpp:985) without Python per-token overhead.
// Returns token count, or -1 on non-ASCII input (caller falls back).
int32_t irs_tokenize_to_tids(void* h, char* text, int32_t len,
                             int32_t case_mode, int32_t word_break,
                             int32_t* tids_out, int32_t cap);

}  // extern "C"

extern "C" {

// Tokenize ASCII text: word chars are [A-Za-z0-9_'], tokens are maximal
// runs with leading/trailing ASCII apostrophes stripped. Returns the token
// count (clamped to cap). For each token i: out_se[2i]=start, out_se[2i+1]=
// end (byte offsets). case_mode: 0=lower,1=none,2=upper — case folding is
// applied IN PLACE on `text`. word_break: 0=alpha (keep tokens containing a
// letter or digit), 1=all, 2=graphic. Returns -1 if any non-ASCII byte is
// present (caller falls back to the Unicode path).
int32_t irs_tokenize_ascii(char* text, int32_t len, int32_t case_mode,
                           int32_t word_break, int32_t* out_se, int32_t cap) {
  auto is_word = [](unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_' || c == '\'';
  };
  for (int32_t i = 0; i < len; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  if (case_mode == 0) {
    for (int32_t i = 0; i < len; ++i) {
      char c = text[i];
      if (c >= 'A' && c <= 'Z') text[i] = c + 32;
    }
  } else if (case_mode == 2) {
    for (int32_t i = 0; i < len; ++i) {
      char c = text[i];
      if (c >= 'a' && c <= 'z') text[i] = c - 32;
    }
  }
  int32_t n = 0;
  int32_t i = 0;
  while (i < len && n < cap) {
    while (i < len && !is_word(static_cast<unsigned char>(text[i]))) ++i;
    if (i >= len) break;
    int32_t start = i;
    while (i < len && is_word(static_cast<unsigned char>(text[i]))) ++i;
    int32_t end = i;
    // strip apostrophes at both ends (python: w.strip("'"))
    while (start < end && text[start] == '\'') ++start;
    while (end > start && text[end - 1] == '\'') --end;
    if (start >= end) continue;
    if (word_break == 0) {  // alpha: need a letter or digit
      bool ok = false;
      for (int32_t j = start; j < end && !ok; ++j) {
        unsigned char c = text[j];
        ok = (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
             (c >= '0' && c <= '9');
      }
      if (!ok) continue;
    }
    out_se[2 * n] = start;
    out_se[2 * n + 1] = end;
    ++n;
  }
  return n;
}

int32_t irs_tokenize_to_tids(void* h, char* text, int32_t len,
                             int32_t case_mode, int32_t word_break,
                             int32_t* tids_out, int32_t cap) {
  auto* dict = static_cast<TermDict*>(h);
  auto is_word = [](unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_' || c == '\'';
  };
  for (int32_t i = 0; i < len; ++i) {
    if (static_cast<unsigned char>(text[i]) >= 0x80) return -1;
  }
  if (case_mode == 0) {
    for (int32_t i = 0; i < len; ++i) {
      char c = text[i];
      if (c >= 'A' && c <= 'Z') text[i] = c + 32;
    }
  } else if (case_mode == 2) {
    for (int32_t i = 0; i < len; ++i) {
      char c = text[i];
      if (c >= 'a' && c <= 'z') text[i] = c - 32;
    }
  }
  int32_t n = 0;
  int32_t i = 0;
  while (i < len && n < cap) {
    while (i < len && !is_word(static_cast<unsigned char>(text[i]))) ++i;
    if (i >= len) break;
    int32_t start = i;
    while (i < len && is_word(static_cast<unsigned char>(text[i]))) ++i;
    int32_t end = i;
    while (start < end && text[start] == '\'') ++start;
    while (end > start && text[end - 1] == '\'') --end;
    if (start >= end) continue;
    if (word_break == 0) {
      bool ok = false;
      for (int32_t j = start; j < end && !ok; ++j) {
        unsigned char c = text[j];
        ok = (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
             (c >= '0' && c <= '9');
      }
      if (!ok) continue;
    }
    tids_out[n++] = dict->add(std::string_view(text + start, end - start));
  }
  return n;
}

// ---- UTF-8 tokenizer ------------------------------------------------
// Unicode property tables generated at build time FROM the Python
// runtime (gen_unicode_tables.py), so token output is byte-identical to
// the Python segmentation analyzer's regex-\w / isalpha / lower()
// semantics by construction (reference: segmentation_token_stream.cpp
// uses ICU; here the table is the contract).
#include "unicode_tables.inc"

static inline uint8_t u_flags(uint32_t cp) {
  if (cp >= 0x110000u) return 0;
  return u_flag_data[u_flag_index[cp >> 8]][cp & 0xFF];
}
static inline int32_t u_lower_delta(uint32_t cp) {
  return u_lower_data[u_lower_index[cp >> 8]][cp & 0xFF];
}
static inline int32_t u_upper_delta(uint32_t cp) {
  return u_upper_data[u_upper_index[cp >> 8]][cp & 0xFF];
}

// decode one UTF-8 code point at text[i]; returns cp or UINT32_MAX on
// malformed input; advances i past the sequence
static inline uint32_t u8_next(const unsigned char* t, int32_t len,
                               int32_t& i) {
  const unsigned char c = t[i];
  if (c < 0x80) { ++i; return c; }
  int32_t n;
  uint32_t cp;
  if ((c >> 5) == 0x6) { n = 1; cp = c & 0x1F; }
  else if ((c >> 4) == 0xE) { n = 2; cp = c & 0x0F; }
  else if ((c >> 3) == 0x1E) { n = 3; cp = c & 0x07; }
  else { return 0xFFFFFFFFu; }
  if (i + n >= len) return 0xFFFFFFFFu;  // truncated sequence
  for (int32_t k = 1; k <= n; ++k) {
    const unsigned char cc = t[i + k];
    if ((cc >> 6) != 0x2) return 0xFFFFFFFFu;
    cp = (cp << 6) | (cc & 0x3F);
  }
  i += n + 1;
  if (cp >= 0x110000u || (cp >= 0xD800u && cp <= 0xDFFFu)) return 0xFFFFFFFFu;
  return cp;
}

static inline int32_t u8_emit(uint32_t cp, char* out) {
  if (cp < 0x80) { out[0] = static_cast<char>(cp); return 1; }
  if (cp < 0x800) {
    out[0] = static_cast<char>(0xC0 | (cp >> 6));
    out[1] = static_cast<char>(0x80 | (cp & 0x3F));
    return 2;
  }
  if (cp < 0x10000) {
    out[0] = static_cast<char>(0xE0 | (cp >> 12));
    out[1] = static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out[2] = static_cast<char>(0x80 | (cp & 0x3F));
    return 3;
  }
  out[0] = static_cast<char>(0xF0 | (cp >> 18));
  out[1] = static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
  out[2] = static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
  out[3] = static_cast<char>(0x80 | (cp & 0x3F));
  return 4;
}

// UTF-8 tokenize + term-id lookup: the full write-path inner loop for
// arbitrary Unicode text. Returns token count, or -1 when the text needs
// the Python fallback (malformed UTF-8, or a case-complex code point
// like sharp-s / final-sigma under lower/upper folding).
int32_t irs_tokenize_to_tids_utf8(void* h, const char* text, int32_t len,
                                  int32_t case_mode, int32_t word_break,
                                  int32_t* tids_out, int32_t cap) {
  auto* dict = static_cast<TermDict*>(h);
  const unsigned char* t = reinterpret_cast<const unsigned char*>(text);
  // ASCII fast path: identical semantics, no decode
  bool ascii = true;
  for (int32_t i = 0; i < len; ++i) {
    if (t[i] >= 0x80) { ascii = false; break; }
  }
  if (ascii) {
    std::string copy(text, len);  // the ASCII path folds case in place
    return irs_tokenize_to_tids(h, copy.data(), len, case_mode, word_break,
                                tids_out, cap);
  }
  std::vector<uint32_t> cps;
  cps.reserve(len);
  int32_t i = 0;
  while (i < len) {
    uint32_t cp = u8_next(t, len, i);
    if (cp == 0xFFFFFFFFu) return -1;
    cps.push_back(cp);
  }
  const int32_t n_cps = static_cast<int32_t>(cps.size());
  std::string tok;
  int32_t n = 0;
  int32_t j = 0;
  auto is_word = [](uint32_t cp) {
    return (u_flags(cp) & 1) != 0 || cp == '\'';
  };
  while (j < n_cps && n < cap) {
    while (j < n_cps && !is_word(cps[j])) ++j;
    if (j >= n_cps) break;
    int32_t start = j;
    while (j < n_cps && is_word(cps[j])) ++j;
    int32_t end = j;
    while (start < end && cps[start] == '\'') ++start;
    while (end > start && cps[end - 1] == '\'') --end;
    if (start >= end) continue;
    if (word_break == 0) {  // alpha: need a letter or digit
      bool ok = false;
      for (int32_t k = start; k < end && !ok; ++k)
        ok = (u_flags(cps[k]) & 6) != 0;
      if (!ok) continue;
    }
    tok.clear();
    char buf4[4];
    for (int32_t k = start; k < end; ++k) {
      uint32_t cp = cps[k];
      if (case_mode != 1) {
        if (u_flags(cp) & 8) return -1;  // case-complex: Python fallback
        cp = static_cast<uint32_t>(
            static_cast<int64_t>(cp) +
            (case_mode == 0 ? u_lower_delta(cp) : u_upper_delta(cp)));
      }
      tok.append(buf4, u8_emit(cp, buf4));
    }
    tids_out[n++] = dict->add(tok);
  }
  return n;
}

// ---- DFA x sorted-dictionary intersection ---------------------------
// The reference intersects a byte automaton with the term index so only
// reachable subtrees are visited (automaton_utils.hpp:91-321,
// formats_burst_trie.cpp:3139). Over a sorted term array the analog is:
// keep a per-depth DFA state stack, resume each term at its longest
// common prefix with the previous term, and on a dead state at depth d
// binary-search past every term sharing prefix[0:d+1] (subtree skip).
// trans is [S][256] u16 with 0xFFFF = dead; accept is [S] u8.
// Returns the match count written to out_tids (clamped to cap).
int32_t irs_dfa_intersect(const char* blob, const int64_t* offsets,
                          int64_t lo, int64_t hi, const uint16_t* trans,
                          const uint8_t* accept, int32_t* out_tids,
                          int32_t cap) {
  constexpr uint16_t kDead = 0xFFFF;
  std::vector<uint16_t> stack;  // stack[d] = state BEFORE consuming byte d
  stack.reserve(64);
  stack.push_back(0);
  int32_t n = 0;
  int64_t prev_off = 0, prev_len = -1;  // previous term (for lcp)
  int64_t t = lo;
  while (t < hi && n < cap) {
    const int64_t off = offsets[t];
    const int64_t len = offsets[t + 1] - off;
    // lcp with the previous visited term bounds the reusable stack depth
    int64_t lcp = 0;
    if (prev_len >= 0) {
      const int64_t m = std::min(prev_len, len);
      while (lcp < m && blob[prev_off + lcp] == blob[off + lcp]) ++lcp;
      if (lcp >= static_cast<int64_t>(stack.size()))
        lcp = static_cast<int64_t>(stack.size()) - 1;
    }
    stack.resize(lcp + 1);
    uint16_t st = stack.back();
    int64_t d = lcp;
    for (; d < len; ++d) {
      st = trans[static_cast<size_t>(st) * 256 +
                 static_cast<unsigned char>(blob[off + d])];
      if (st == kDead) break;
      stack.push_back(st);
    }
    prev_off = off;
    prev_len = (d == len) ? len : d + 1;  // compared bytes incl. the dead one
    if (d == len) {
      if (accept[st == kDead ? 0 : st] && st != kDead) out_tids[n++] = (int32_t)t;
      ++t;
      continue;
    }
    // dead at byte d: skip every term sharing prefix blob[off, off+d+1)
    // via binary search for the prefix successor
    const int64_t plen = d + 1;
    int64_t a = t + 1, b = hi;
    while (a < b) {
      const int64_t mid = a + ((b - a) >> 1);
      const int64_t moff = offsets[mid];
      const int64_t mlen = offsets[mid + 1] - moff;
      const int64_t m = std::min(mlen, plen);
      int cmpv = std::memcmp(blob + moff, blob + off, (size_t)m);
      if (cmpv == 0) cmpv = (mlen < plen) ? -1 : 0;  // prefix-equal => inside
      if (cmpv <= 0) a = mid + 1; else b = mid;
    }
    t = a;
    // the stack (and prev term) stay valid: the next term's lcp against
    // prev is computed fresh
  }
  return n;
}

// Batch banded Damerau-Levenshtein. query/cands are UTF-32 code points.
// cands is [num_cands * max_len], lengths in cand_len. Distances written
// to out (values > max_d are reported as max_d + 1). with_transpositions
// enables the Damerau transposition case (restricted edit distance, same
// as the reference's parametric description with transpositions).
void irs_levenshtein_batch(const uint32_t* query, int32_t qlen,
                           const uint32_t* cands, const int32_t* cand_len,
                           int32_t num_cands, int32_t max_len, int32_t max_d,
                           int32_t with_transpositions, int32_t* out) {
  const int32_t INF = max_d + 1;
  // rows: DP over query (i) x candidate (j) with |i-j| <= max_d band
  // three rolling rows of length (max_len + 1)
  int32_t* prev2 = new int32_t[max_len + 1];
  int32_t* prev = new int32_t[max_len + 1];
  int32_t* cur = new int32_t[max_len + 1];
  for (int32_t t = 0; t < num_cands; ++t) {
    const uint32_t* c = cands + static_cast<int64_t>(t) * max_len;
    const int32_t cl = cand_len[t];
    if (std::abs(cl - qlen) > max_d) {
      out[t] = INF;
      continue;
    }
    for (int32_t j = 0; j <= cl; ++j) prev[j] = j <= max_d ? j : INF;
    int32_t result = (qlen == 0) ? std::min(cl, INF) : INF;
    for (int32_t i = 1; i <= qlen; ++i) {
      const int32_t jlo = std::max(1, i - max_d);
      const int32_t jhi = std::min(cl, i + max_d);
      cur[0] = i <= max_d ? i : INF;
      if (jlo > 1) cur[jlo - 1] = INF;
      int32_t row_min = cur[0];
      for (int32_t j = jlo; j <= jhi; ++j) {
        const int32_t sub = prev[j - 1] + (c[j - 1] != query[i - 1] ? 1 : 0);
        const int32_t del = (j <= i + max_d - 1 ? prev[j] : INF) + 1;
        const int32_t ins = cur[j - 1] + 1;
        int32_t best = std::min(sub, std::min(del, ins));
        if (with_transpositions && i > 1 && j > 1 && c[j - 1] == query[i - 2] &&
            c[j - 2] == query[i - 1]) {
          best = std::min(best, prev2[j - 2] + 1);
        }
        cur[j] = std::min(best, INF);
        row_min = std::min(row_min, cur[j]);
      }
      if (jhi < cl) cur[jhi + 1 <= cl ? jhi + 1 : cl] = INF;
      std::swap(prev2, prev);
      std::swap(prev, cur);
      if (row_min > max_d) {  // band exhausted: early exit
        result = INF;
        goto done;
      }
    }
    result = prev[cl];  // after final swap, prev holds the last row
  done:
    out[t] = std::min(result, INF);
  }
  delete[] prev2;
  delete[] prev;
  delete[] cur;
}

// ---- consolidation merge kernels -------------------------------------
// The reference treats segment merging as a HOT path (merge_writer.cpp,
// SURVEY §3.6): full decode -> doc-id remap -> union -> re-encode. The
// numpy merge (index/merge.py) is vectorized but makes ~10 full passes
// over E-sized temporaries plus a 2-key lexsort; these kernels do the
// decode+remap in ONE streaming pass per segment and gather position
// runs straight from the packed pools into the merged layout. Packed
// layout per formats/bitpack.py: at width b (pow2, classes
// {1,2,4,8,16,32}), lane j of a 128-lane block row lives in word
// j % (4b) at bit (j / (4b)) * b.

namespace {

struct PlanarReader {
  const uint32_t* words;  // pool rows: [rows, 4b] u32
  uint32_t wl;            // log2(words per block) = log2(4b)
  uint32_t bl;            // log2(b)
  uint32_t mask;          // (1<<b)-1 (0xFFFFFFFF for b=32)

  inline uint32_t at(int64_t row, uint32_t lane) const {
    const uint32_t wpb_mask = (1u << wl) - 1u;
    const uint32_t shift = (lane >> wl) << bl;
    return (words[(static_cast<uint64_t>(row) << wl) + (lane & wpb_mask)] >>
            shift) & mask;
  }
};

inline PlanarReader reader_for(const uint32_t* const* pools, uint32_t cls) {
  static const uint32_t kWl[6] = {2, 3, 4, 5, 6, 7};
  static const uint32_t kBl[6] = {0, 1, 2, 3, 4, 5};
  static const uint32_t kMask[6] = {1u,          3u,         15u,
                                    255u,        65535u,     0xFFFFFFFFu};
  return PlanarReader{pools[cls], kWl[cls], kBl[cls], kMask[cls]};
}

}  // namespace

// Decode + remap one segment field in one streaming pass.
// entries: u32 [T, ncols] (TermCols layout: DF=0, DCLS=2, FCLS=3,
// DSTART=4, FSTART=5). dmap[old_doc] = new global doc id or -1 (masked).
// tid_remap[t] = merged term id. Outputs (caller allocates E = sum df):
// kept entries' merged tid / new doc / freq / original tid / global flat
// source position offset (cumsum of freq over ALL entries, kept or not —
// the flat rank the OFFS/PAY streams and positions_flat() use).
// Returns the kept count.
int64_t irs_merge_decode(const uint32_t* entries, int64_t T, int64_t ncols,
                         const uint32_t* const* doc_words,
                         const uint32_t* const* base_pools,
                         const uint32_t* const* freq_words,
                         const int64_t* dmap, const int64_t* tid_remap,
                         int32_t* out_tid, uint32_t* out_doc,
                         uint32_t* out_freq, int32_t* out_orig_tid,
                         int64_t* out_posoff) {
  int64_t n = 0;
  int64_t pos_off = 0;  // global flat position rank (all entries)
  for (int64_t t = 0; t < T; ++t) {
    const uint32_t* e = entries + t * ncols;
    const int64_t df = e[0];          // TermCols.DF
    const uint32_t dcls = e[2];       // DCLS
    const uint32_t fcls = e[3];       // FCLS
    const int64_t dstart = e[4];      // DSTART
    const int64_t fstart = e[5];      // FSTART
    const PlanarReader dr = reader_for(doc_words, dcls);
    const PlanarReader fr = reader_for(freq_words, fcls);
    const uint32_t* base = base_pools[dcls];
    const int64_t mt = tid_remap[t];
    uint32_t doc = 0;
    for (int64_t r = 0; r < df; ++r) {
      const int64_t b = r >> 7;
      const uint32_t l = static_cast<uint32_t>(r & 127);
      if (l == 0) {
        doc = base[dstart + b];
      } else {
        doc += dr.at(dstart + b, l);
      }
      const uint32_t f = fr.at(fstart + b, l);
      const int64_t nd = dmap[doc];
      if (nd >= 0) {
        out_tid[n] = static_cast<int32_t>(mt);
        out_doc[n] = static_cast<uint32_t>(nd);
        out_freq[n] = f;
        out_orig_tid[n] = static_cast<int32_t>(t);
        out_posoff[n] = pos_off;
        ++n;
      }
      pos_off += f;
    }
  }
  return n;
}

// Gather kept entries' position runs from the packed per-term position
// pools straight into the merged flat layout. For kept entry i of the
// source segment: its positions are the run [src_off[i] -
// tid_pos_base[orig_tid[i]], +freq[i]) WITHIN term orig_tid[i]'s packed
// stream (PCLS=entries[.,10], PSTART=entries[.,11]); they are written to
// out_pos[dst_off[i] ...]. tid_pos_base[t] = flat rank of term t's first
// position (int64 cumsum of TTF, host-computed).
void irs_merge_gather_pos(const uint32_t* entries, int64_t ncols,
                          const uint32_t* const* pos_words,
                          const int64_t* tid_pos_base,
                          const int32_t* orig_tid, const int64_t* src_off,
                          const uint32_t* freq, const int64_t* dst_off,
                          int64_t E, uint32_t* out_pos) {
  for (int64_t i = 0; i < E; ++i) {
    const int64_t t = orig_tid[i];
    const uint32_t* e = entries + t * ncols;
    const PlanarReader pr = reader_for(pos_words, e[10]);  // PCLS
    const int64_t pstart = e[11];                          // PSTART
    int64_t q = src_off[i] - tid_pos_base[t];  // within-term position rank
    uint32_t* dst = out_pos + dst_off[i];
    for (uint32_t j = 0; j < freq[i]; ++j, ++q) {
      dst[j] = pr.at(pstart + (q >> 7), static_cast<uint32_t>(q & 127));
    }
  }
}

// Generic run-copy for the flat position-parallel streams (offsets,
// payload lengths): out[dst_off[i] + j] = src[src_off[i] + j].
void irs_copy_runs_u32(const uint32_t* src, const int64_t* src_off,
                       const int64_t* dst_off, const uint32_t* len,
                       int64_t E, uint32_t* out) {
  for (int64_t i = 0; i < E; ++i) {
    std::memcpy(out + dst_off[i], src + src_off[i],
                static_cast<size_t>(len[i]) * sizeof(uint32_t));
  }
}

// Byte-range run copy (payload blobs).
void irs_copy_runs_bytes(const uint8_t* src, const int64_t* src_off,
                         const int64_t* dst_off, const int64_t* len,
                         int64_t E, uint8_t* out) {
  for (int64_t i = 0; i < E; ++i) {
    std::memcpy(out + dst_off[i], src + src_off[i],
                static_cast<size_t>(len[i]));
  }
}

// crc32c (Castagnoli, software table) — blobpack checksum helper.
static uint32_t crc32c_table[256];
static bool crc32c_init_done = false;
static void crc32c_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ (0x82F63B78u & (0u - (crc & 1)));
    crc32c_table[i] = crc;
  }
  crc32c_init_done = true;
}

uint32_t irs_crc32c(const uint8_t* data, int64_t len, uint32_t seed) {
  if (!crc32c_init_done) crc32c_init();
  uint32_t crc = ~seed;
  for (int64_t i = 0; i < len; ++i)
    crc = (crc >> 8) ^ crc32c_table[(crc ^ data[i]) & 0xFF];
  return ~crc;
}

// Scatter-pack: write classed planar bit-packed pools in ONE pass over
// the element stream (the encoder hot loop; replaces the per-class
// numpy mask -> zeroed [rows,128] matrix -> pack_blocks pipeline, which
// zeroes + re-reads every pool twice). Planar layout per
// formats/bitpack.py: at width b, lane j of a 128-lane block lives in
// word j % (4b) at bit (j / (4b)) * b. Widths are the pow2 classes
// {1,2,4,8,16,32}, so word-column and shift are shift/mask arithmetic.
// ``outs`` are pre-zeroed per-class word arrays (row 0 = sentinel).
void irs_scatter_pack(const uint32_t* vals, const int64_t* row,
                      const uint8_t* lane, const uint8_t* cls, int64_t n,
                      uint32_t** outs) {
  static const uint32_t kBits[6] = {1, 2, 4, 8, 16, 32};
  // wpb = 4*b is a power of two: log2(wpb) and log2(b) per class
  static const uint32_t kWpbLog[6] = {2, 3, 4, 5, 6, 7};
  static const uint32_t kBitLog[6] = {0, 1, 2, 3, 4, 5};
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t c = cls[i];
    const uint32_t wl = kWpbLog[c];
    const uint32_t wpb_mask = (1u << wl) - 1u;
    const uint32_t j = lane[i];
    const uint32_t shift = (j >> wl) << kBitLog[c];
    outs[c][(static_cast<uint64_t>(row[i]) << wl) + (j & wpb_mask)] |=
        vals[i] << shift;
  }
  (void)kBits;
}

}  // extern "C"

// ---- dense-grid cache builder ----------------------------------------
// Reader-side acceleration (formats/dense.py:build_dense_cache): repack
// each high-df term's postings in doc-grid order plus per-row skyline
// summaries. The numpy builder sweeps a full [ndrows, 128] grid ~10x per
// term (pack, max, argmin, argmax, where-chains) — ~120 ms/term at 5M
// docs; this kernel streams each term's df entries ONCE, writing the
// planar packed words and updating the row summaries in place, then
// finishes with one pass over the span's rows for empty-row defaults.
// Output semantics are IDENTICAL to the numpy builder (tie-breaks keep
// the first lane: entries arrive doc-ascending, so strictly-greater /
// strictly-less updates reproduce argmax/argmin first-occurrence; the
// champion score f/((f+c0)+c1*dl) is evaluated in float like numpy's
// f32 ops). Verified element-equal in tests/test_dense_native.py.
//
// entries/doc_words/base_pools/freq_words: as irs_merge_decode.
// tids: the class's selected term ids; term i's span starts at row
// 1 + i*ndrows (row 0 = zero sentinel). dl: f32 [ndrows*128] clamped
// doc lengths (pad lanes 1.0). alive: u8 [num_docs] or NULL.
// Outputs (caller allocates/zeroes; dl_c pre-filled with 1):
// packed u32 [(1+nt*ndrows) * wpb], bmaxf u32, dl_min/f_c/dl_c/f_mdl u16.
extern "C" void irs_dense_build(const uint32_t* entries, int64_t ncols,
                     const uint32_t* const* doc_words,
                     const uint32_t* const* base_pools,
                     const uint32_t* const* freq_words,
                     const int32_t* tids, int64_t nt, int64_t ndrows,
                     uint32_t cls, const float* dl, const uint8_t* alive,
                     double c0_d, double c1_d, uint32_t* packed,
                     uint32_t* bmaxf, uint16_t* dl_min, uint16_t* f_c,
                     uint16_t* dl_c, uint16_t* f_mdl) {
  const float c0 = static_cast<float>(c0_d);
  const float c1 = static_cast<float>(c1_d);
  static const uint32_t kWl[6] = {2, 3, 4, 5, 6, 7};
  static const uint32_t kBl[6] = {0, 1, 2, 3, 4, 5};
  const uint32_t wl = kWl[cls];
  const uint32_t bl = kBl[cls];
  const uint32_t wpb_mask = (1u << wl) - 1u;
  // per-row scratch for one term's span
  float* best_s = new float[ndrows];
  float* best_d = new float[ndrows];
  uint32_t* champ_f = new uint32_t[ndrows];
  float* champ_d = new float[ndrows];
  uint32_t* mdl_f = new uint32_t[ndrows];

  for (int64_t i = 0; i < nt; ++i) {
    const int64_t t = tids[i];
    const uint32_t* e = entries + t * ncols;
    const int64_t df = e[0];      // TermCols.DF
    const uint32_t dcls = e[2];   // DCLS
    const uint32_t fcls = e[3];   // FCLS
    const int64_t dstart = e[4];  // DSTART
    const int64_t fstart = e[5];  // FSTART
    const PlanarReader dr = reader_for(doc_words, dcls);
    const PlanarReader fr = reader_for(freq_words, fcls);
    const uint32_t* base = base_pools[dcls];
    const int64_t span = 1 + i * ndrows;
    for (int64_t r = 0; r < ndrows; ++r) {
      best_s[r] = -1.0f;  // numpy: non-hit lanes score -1
      best_d[r] = std::numeric_limits<float>::infinity();
      champ_f[r] = 0;
      champ_d[r] = 0.0f;
      mdl_f[r] = 0;
    }
    uint32_t doc = 0;
    for (int64_t r = 0; r < df; ++r) {
      const int64_t b = r >> 7;
      const uint32_t l = static_cast<uint32_t>(r & 127);
      if (l == 0) {
        doc = base[dstart + b];
      } else {
        doc += dr.at(dstart + b, l);
      }
      if (alive && !alive[doc]) continue;
      const uint32_t f = fr.at(fstart + b, l);
      const int64_t row = doc >> 7;
      const uint32_t lane = doc & 127u;
      // planar packed write (lane j -> word j % wpb, bit (j/wpb)*b)
      packed[((span + row) << wl) + (lane & wpb_mask)] |=
        f << ((lane >> wl) << bl);
      const int64_t pr = span + row;
      if (f > bmaxf[pr]) bmaxf[pr] = f;
      const float d = dl[doc];
      const float ff = static_cast<float>(f);
      const float s = ff / ((ff + c0) + (c1 * d));
      if (s > best_s[row]) {
        best_s[row] = s;
        champ_f[row] = f;
        champ_d[row] = d;
      }
      if (d < best_d[row]) {
        best_d[row] = d;
        mdl_f[row] = f;
      }
    }
    for (int64_t r = 0; r < ndrows; ++r) {
      const int64_t pr = span + r;
      const bool any = bmaxf[pr] != 0;  // postings freq >= 1 when present
      if (any) {
        const float dmin = best_d[r];
        const float dmin_u = dmin < 65535.0f ? dmin : 65535.0f;
        dl_min[pr] = static_cast<uint16_t>(dmin_u);
        f_mdl[pr] = static_cast<uint16_t>(
          dmin <= 65535.0f ? (mdl_f[r] < 65535u ? mdl_f[r] : 65535u) : 0u);
        const uint32_t fc =
          champ_f[r] < 65535u ? champ_f[r] : 65535u;
        const float dc = champ_d[r];
        if (dc > 65535.0f) {  // overflowing dl: zero the pair (valid lb)
          f_c[pr] = 0;
          dl_c[pr] = 1;
        } else {
          f_c[pr] = static_cast<uint16_t>(fc);
          dl_c[pr] = static_cast<uint16_t>(dc);
        }
      } else {
        // numpy empty-row defaults: dmin -> 1.0, champion jc = lane 0
        // of the zero grid (fc = 0, dc = dl[row*128])
        dl_min[pr] = 1;
        f_mdl[pr] = 0;
        const float dc = dl[r << 7];
        if (dc > 65535.0f) {
          f_c[pr] = 0;
          dl_c[pr] = 1;
        } else {
          f_c[pr] = 0;
          dl_c[pr] = static_cast<uint16_t>(dc);
        }
      }
    }
  }
  delete[] best_s;
  delete[] best_d;
  delete[] champ_f;
  delete[] champ_d;
  delete[] mdl_f;
}

// ---------------------------------------------------------------------------
// NFA -> DFA subset construction (byte alphabet, range edges, epsilon
// moves). The reference precomputes parametric Levenshtein descriptions
// (core/utils/levenshtein_default_pdp.cpp) so per-query automaton
// construction is cheap; here the generic determinizer is moved to C++
// with bitset subsets instead, which makes per-query construction of the
// wildcard/Levenshtein byte DFAs ~100x faster than the Python subset
// construction while producing the identical table (tests pin equality).
//
// Inputs describe the NFA: range edges (src, lo, hi, dst), epsilon edges,
// and an accept mask over NFA states. State 0 is the start. Outputs the
// dense transition table out_trans[s*256 + b] (0xFFFF = dead) and
// out_accept[s], DFA states in discovery order (bytes scanned 0..255 per
// subset) — the same order the Python fallback produces, so the two are
// bit-identical. Returns the DFA state count, or -1 when max_states
// would be exceeded (caller falls back, mirroring the Python budget).

extern "C" int32_t irs_dfa_determinize(
    int32_t n_states, int64_t n_edges, const int32_t* edge_src,
    const uint8_t* edge_lo, const uint8_t* edge_hi, const int32_t* edge_dst,
    int64_t n_eps, const int32_t* eps_src, const int32_t* eps_dst,
    const uint8_t* accept_mask, int32_t max_states, uint16_t* out_trans,
    uint8_t* out_accept) {
  constexpr uint16_t kDead = 0xFFFF;
  const int32_t W = (n_states + 63) >> 6;  // u64 words per bitset

  // Reflexive-transitive epsilon closure rows C[s]: propagate
  // row[src] |= row[dst] over the eps edges until fixpoint (eps graphs
  // here are shallow DAGs — deletions/prefix hops — so a few passes).
  std::vector<uint64_t> C(static_cast<size_t>(n_states) * W, 0);
  for (int32_t s = 0; s < n_states; ++s)
    C[static_cast<size_t>(s) * W + (s >> 6)] |= 1ull << (s & 63);
  bool changed = true;
  while (changed) {
    changed = false;
    for (int64_t e = 0; e < n_eps; ++e) {
      uint64_t* rs = &C[static_cast<size_t>(eps_src[e]) * W];
      const uint64_t* rd = &C[static_cast<size_t>(eps_dst[e]) * W];
      for (int32_t w = 0; w < W; ++w) {
        const uint64_t nv = rs[w] | rd[w];
        if (nv != rs[w]) {
          rs[w] = nv;
          changed = true;
        }
      }
    }
  }

  // Accept bitset.
  std::vector<uint64_t> A(W, 0);
  for (int32_t s = 0; s < n_states; ++s)
    if (accept_mask[s]) A[s >> 6] |= 1ull << (s & 63);

  // CSR edge buckets by src state.
  std::vector<int32_t> deg(n_states + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) deg[edge_src[e] + 1]++;
  for (int32_t s = 0; s < n_states; ++s) deg[s + 1] += deg[s];
  std::vector<int32_t> eid(n_edges);
  {
    std::vector<int32_t> cur(deg.begin(), deg.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) eid[cur[edge_src[e]]++] = (int32_t)e;
  }

  // Byte equivalence classes: bytes between adjacent edge boundaries are
  // indistinguishable to every NFA state, so the subset work runs per
  // CLASS (~10-30 of them) instead of per byte (256) — this is what
  // makes d=2 construction sub-millisecond. Every edge's [lo, hi] is a
  // union of whole classes by construction of the boundary set.
  bool mark[257] = {false};
  mark[0] = mark[256] = true;
  for (int64_t e = 0; e < n_edges; ++e) {
    mark[edge_lo[e]] = true;
    mark[(int32_t)edge_hi[e] + 1] = true;
  }
  int32_t class_of[256];
  int32_t K = -1;
  for (int32_t b = 0; b < 256; ++b) {
    if (mark[b]) ++K;
    class_of[b] = K;
  }
  ++K;  // class count
  // per-edge class span
  std::vector<int32_t> e_clo(n_edges), e_chi(n_edges);
  for (int64_t e = 0; e < n_edges; ++e) {
    e_clo[e] = class_of[edge_lo[e]];
    e_chi[e] = class_of[edge_hi[e]];
  }

  auto key_of = [W](const uint64_t* row) {
    return std::string(reinterpret_cast<const char*>(row),
                       static_cast<size_t>(W) * 8);
  };

  std::unordered_map<std::string, int32_t> index;
  std::vector<uint64_t> subsets;  // closed subset bitsets, [n_dfa * W]
  subsets.reserve(static_cast<size_t>(W) * 64);

  // start = closure({0}) = C row 0
  subsets.insert(subsets.end(), C.begin(), C.begin() + W);
  index.emplace(key_of(&subsets[0]), 0);
  {
    bool acc = false;
    for (int32_t w = 0; w < W; ++w) acc |= (subsets[w] & A[w]) != 0;
    out_accept[0] = acc ? 1 : 0;
  }

  std::vector<uint64_t> D(static_cast<size_t>(K) * W);
  std::vector<uint64_t> closed(W);
  std::vector<uint16_t> class_to(K);  // class -> DFA dst for this subset
  std::unordered_map<std::string, uint16_t> memo;  // raw -> id, per subset

  int32_t n_dfa = 1;
  for (int32_t qi = 0; qi < n_dfa; ++qi) {
    std::fill(D.begin(), D.end(), 0);
    const uint64_t* cur = &subsets[static_cast<size_t>(qi) * W];
    for (int32_t w = 0; w < W; ++w) {
      uint64_t bits = cur[w];
      while (bits) {
        const int32_t s = (w << 6) + __builtin_ctzll(bits);
        bits &= bits - 1;
        for (int32_t k = deg[s]; k < deg[s + 1]; ++k) {
          const int32_t e = eid[k];
          const int32_t d = edge_dst[e];
          const uint64_t bit = 1ull << (d & 63);
          const int32_t dw = d >> 6;
          for (int32_t c = e_clo[e]; c <= e_chi[e]; ++c)
            D[static_cast<size_t>(c) * W + dw] |= bit;
        }
      }
    }
    memo.clear();
    for (int32_t c = 0; c < K; ++c) {
      const uint64_t* raw = &D[static_cast<size_t>(c) * W];
      bool any = false;
      for (int32_t w = 0; w < W; ++w) any |= raw[w] != 0;
      if (!any) {
        class_to[c] = kDead;
        continue;
      }
      const std::string rkey(reinterpret_cast<const char*>(raw),
                             static_cast<size_t>(W) * 8);
      auto mit = memo.find(rkey);
      if (mit != memo.end()) {
        class_to[c] = mit->second;
        continue;
      }
      // epsilon-close the raw destination set
      std::fill(closed.begin(), closed.end(), 0);
      for (int32_t w = 0; w < W; ++w) {
        uint64_t bits = raw[w];
        while (bits) {
          const int32_t s = (w << 6) + __builtin_ctzll(bits);
          bits &= bits - 1;
          const uint64_t* cr = &C[static_cast<size_t>(s) * W];
          for (int32_t x = 0; x < W; ++x) closed[x] |= cr[x];
        }
      }
      const std::string ckey = key_of(closed.data());
      auto it = index.find(ckey);
      int32_t j;
      if (it != index.end()) {
        j = it->second;
      } else {
        j = n_dfa;
        if (j >= max_states) return -1;
        index.emplace(ckey, j);
        subsets.insert(subsets.end(), closed.begin(), closed.end());
        bool acc = false;
        for (int32_t w = 0; w < W; ++w) acc |= (closed[w] & A[w]) != 0;
        out_accept[j] = acc ? 1 : 0;
        ++n_dfa;
      }
      memo.emplace(rkey, static_cast<uint16_t>(j));
      class_to[c] = static_cast<uint16_t>(j);
    }
    uint16_t* row = out_trans + static_cast<size_t>(qi) * 256;
    for (int32_t b = 0; b < 256; ++b) row[b] = class_to[class_of[b]];
  }
  return n_dfa;
}

// ---------------------------------------------------------------------------
// One-call (Damerau-)Levenshtein byte-DFA build: constructs the position NFA
// (match / substitute / insert / delete / restricted transpose over UTF-8
// byte expansions) and determinizes it, all native. State numbering mirrors
// search/automaton.py:levenshtein_dfa exactly — start, prefix chain, grid
// (i, e) rows, then UTF-8 mid states in edge-emission order — so the DFA
// tables are BIT-IDENTICAL to the Python construction (pinned by
// tests/test_automaton.py); this is a pure prepare-latency collapse of the
// per-query fuzzy cost into one C call. The reference amortizes the same
// cost with precomputed parametric tables
// (core/utils/levenshtein_default_pdp.cpp); one-call native construction
// plays that role here at ~tens of microseconds per term.
extern "C" int32_t irs_lev_dfa_build(
    const uint32_t* q, int32_t qlen, int32_t max_d, int32_t transpose,
    const uint8_t* prefix, int32_t plen, int32_t max_states,
    uint16_t* out_trans, uint8_t* out_accept) {
  std::vector<int32_t> esrc, edst;
  std::vector<uint8_t> elo, ehi;
  std::vector<int32_t> psrc, pdst;  // epsilon edges
  const size_t approx_edges =
      static_cast<size_t>((max_d + 1)) * (qlen + 1) * 16 + plen + 8;
  esrc.reserve(approx_edges);
  edst.reserve(approx_edges);
  elo.reserve(approx_edges);
  ehi.reserve(approx_edges);
  int32_t n_states = 0;
  auto new_state = [&]() { return n_states++; };
  auto edge = [&](int32_t s, uint8_t lo, uint8_t hi, int32_t d) {
    esrc.push_back(s);
    elo.push_back(lo);
    ehi.push_back(hi);
    edst.push_back(d);
  };
  const int32_t start = new_state();
  int32_t cur = start;
  for (int32_t i = 0; i < plen; ++i) {
    const int32_t nxt = new_state();
    edge(cur, prefix[i], prefix[i], nxt);
    cur = nxt;
  }
  // grid ids: (i, e) -> grid[e * stride + i], allocated e-major like the
  // Python loop so numbering matches.
  const int32_t stride = qlen + 1;
  std::vector<int32_t> grid(static_cast<size_t>(max_d + 1) * stride);
  for (int32_t e = 0; e <= max_d; ++e)
    for (int32_t i = 0; i <= qlen; ++i)
      grid[static_cast<size_t>(e) * stride + i] = new_state();
  psrc.push_back(cur);
  pdst.push_back(grid[0]);

  auto char_edge = [&](int32_t src, uint32_t cp, int32_t dst) {
    char bs[4];
    const int32_t n = u8_emit(cp, bs);
    int32_t c2 = src;
    for (int32_t k = 0; k < n - 1; ++k) {
      const int32_t mid = new_state();
      edge(c2, static_cast<uint8_t>(bs[k]), static_cast<uint8_t>(bs[k]), mid);
      c2 = mid;
    }
    edge(c2, static_cast<uint8_t>(bs[n - 1]), static_cast<uint8_t>(bs[n - 1]),
         dst);
  };
  // the 4-branch "any UTF-8 character" fragment (automaton.py:_UTF8_ANY)
  static const uint8_t kAny[4][4][2] = {
      {{0x00, 0x7F}, {0, 0}, {0, 0}, {0, 0}},
      {{0xC2, 0xDF}, {0x80, 0xBF}, {0, 0}, {0, 0}},
      {{0xE0, 0xEF}, {0x80, 0xBF}, {0x80, 0xBF}, {0, 0}},
      {{0xF0, 0xF4}, {0x80, 0xBF}, {0x80, 0xBF}, {0x80, 0xBF}},
  };
  auto any_edge = [&](int32_t src, int32_t dst) {
    for (int32_t br = 0; br < 4; ++br) {
      const int32_t blen = br + 1;
      int32_t c2 = src;
      for (int32_t k = 0; k < blen - 1; ++k) {
        const int32_t mid = new_state();
        edge(c2, kAny[br][k][0], kAny[br][k][1], mid);
        c2 = mid;
      }
      edge(c2, kAny[br][blen - 1][0], kAny[br][blen - 1][1], dst);
    }
  };
  for (int32_t e = 0; e <= max_d; ++e)
    for (int32_t i = 0; i <= qlen; ++i) {
      const int32_t s = grid[static_cast<size_t>(e) * stride + i];
      if (i < qlen)
        char_edge(s, q[i], grid[static_cast<size_t>(e) * stride + i + 1]);
      if (e < max_d) {
        any_edge(s, grid[static_cast<size_t>(e + 1) * stride + i]);
        if (i < qlen) {
          const int32_t diag = grid[static_cast<size_t>(e + 1) * stride + i + 1];
          any_edge(s, diag);  // substitution
          psrc.push_back(s);  // deletion
          pdst.push_back(diag);
        }
        if (transpose && i + 1 < qlen) {
          const int32_t mid = new_state();
          char_edge(s, q[i + 1], mid);
          char_edge(mid, q[i],
                    grid[static_cast<size_t>(e + 1) * stride + i + 2]);
        }
      }
    }
  // accept: (i, e) completable by deletions alone — qlen - i <= max_d - e
  std::vector<uint8_t> amask(n_states, 0);
  for (int32_t e = 0; e <= max_d; ++e)
    for (int32_t i = 0; i <= qlen; ++i)
      if (qlen - i <= max_d - e)
        amask[grid[static_cast<size_t>(e) * stride + i]] = 1;
  return irs_dfa_determinize(
      n_states, static_cast<int64_t>(esrc.size()), esrc.data(), elo.data(),
      ehi.data(), edst.data(), static_cast<int64_t>(psrc.size()), psrc.data(),
      pdst.data(), amask.data(), max_states, out_trans, out_accept);
}
