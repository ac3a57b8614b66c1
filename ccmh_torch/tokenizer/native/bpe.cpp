// Native byte-level BPE tokenizer with exact OpenAI-CLIP token-id parity.
//
// The port's copy of ccmh's native tokenizer, the host-side
// serving/throughput twin of ccmh_torch/tokenizer/bpe.py (reference:
// model/base/simple_tokenizer.py:62-143).  The Python wrapper guards the
// fast path to inputs where the reference cleaning pipeline is the
// identity transform up to lowercasing/whitespace (pure ASCII, no HTML
// entities, no literal special tokens); everything else stays on the
// Python tokenizer.  Within that domain this produces bit-identical ids:
// same word-split regex semantics, same greedy lowest-rank-first merge
// loop, same SOT/tokens/EOT/pad-0 layout.
//
// The batch entry point releases the GIL for its whole duration (ctypes)
// and fans out across C++ threads, so the serving daemon's text encode
// no longer serializes tokenization behind the interpreter lock.

#include <cstdint>
#include <cstring>

#include <atomic>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// UTF-8 encode one codepoint (all vocab symbols are < 0x800).
inline void utf8_append(std::string& s, uint32_t cp) {
  if (cp < 0x80) {
    s.push_back(static_cast<char>(cp));
  } else {
    s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// bytes_to_unicode: identical table to the Python/reference tokenizer —
// printable bytes map to themselves, the rest shift into the 0x100 plane.
// `order` records the Python dict's INSERTION order (visible bytes first,
// then the shifted rest): vocab ids are assigned in that order, not in
// byte order.
std::vector<std::string> byte_symbols(std::vector<int>& order) {
  bool visible[256] = {false};
  order.clear();
  for (int b = '!'; b <= '~'; ++b) visible[b] = true;
  for (int b = 0xA1; b <= 0xAC; ++b) visible[b] = true;
  for (int b = 0xAE; b <= 0xFF; ++b) visible[b] = true;
  for (int b = 0; b < 256; ++b)
    if (visible[b]) order.push_back(b);
  std::vector<std::string> table(256);
  int offset = 0;
  for (int b = 0; b < 256; ++b) {
    std::string s;
    if (!visible[b]) order.push_back(b);
    utf8_append(s, visible[b] ? static_cast<uint32_t>(b)
                              : static_cast<uint32_t>(0x100 + offset++));
    table[b] = s;
  }
  return table;
}

constexpr char kSep = '\x01';  // never occurs in vocab symbols

struct Bpe {
  std::vector<std::string> byte_sym;             // 256 single-byte symbols
  std::unordered_map<std::string, int> rank;     // "a\x01b" -> merge rank
  std::unordered_map<std::string, int> encoder;  // token string -> id
  int sot_id = 0, eot_id = 0;
  std::unordered_map<std::string, std::vector<int>> cache;  // word -> ids
  std::shared_mutex cache_mu;
};

// Greedy lowest-rank-first merge of one byte-mapped word (the char list +
// trailing "</w>" formulation of the reference bpe()).
std::vector<int> merge_word(const Bpe& bpe, const std::vector<std::string>& syms) {
  std::vector<std::string> parts;
  parts.reserve(syms.size());
  for (size_t i = 0; i + 1 < syms.size(); ++i) parts.push_back(syms[i]);
  parts.push_back(syms.back() + "</w>");

  std::string key;
  while (parts.size() > 1) {
    int best_rank = -1;
    size_t best_idx = 0;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      key.assign(parts[i]);
      key.push_back(kSep);
      key.append(parts[i + 1]);
      auto it = bpe.rank.find(key);
      if (it != bpe.rank.end() && (best_rank < 0 || it->second < best_rank)) {
        best_rank = it->second;
        best_idx = i;
      }
    }
    if (best_rank < 0) break;
    const std::string a = parts[best_idx], b = parts[best_idx + 1];
    const std::string merged = a + b;
    std::vector<std::string> out;
    out.reserve(parts.size());
    for (size_t i = 0; i < parts.size();) {
      if (i + 1 < parts.size() && parts[i] == a && parts[i + 1] == b) {
        out.push_back(merged);
        i += 2;
      } else {
        out.push_back(parts[i]);
        i += 1;
      }
    }
    parts.swap(out);
  }
  std::vector<int> ids;
  ids.reserve(parts.size());
  for (const auto& p : parts) {
    auto it = bpe.encoder.find(p);
    ids.push_back(it == bpe.encoder.end() ? -1 : it->second);
  }
  return ids;
}

std::vector<int> encode_word(Bpe& bpe, const std::string& word_bytes) {
  {
    std::shared_lock<std::shared_mutex> lock(bpe.cache_mu);
    auto it = bpe.cache.find(word_bytes);
    if (it != bpe.cache.end()) return it->second;
  }
  std::vector<std::string> syms;
  syms.reserve(word_bytes.size());
  for (unsigned char c : word_bytes) syms.push_back(bpe.byte_sym[c]);
  std::vector<int> ids = merge_word(bpe, syms);
  {
    std::unique_lock<std::shared_mutex> lock(bpe.cache_mu);
    bpe.cache.emplace(word_bytes, ids);
  }
  return ids;
}

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
inline bool is_letter(char c) { return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z'); }
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
inline char lower(char c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

// _clean for the guarded ASCII domain: collapse whitespace runs to single
// spaces, strip, lowercase (ftfy / double html-unescape are identity here
// — the Python wrapper rejects '&' and non-ASCII).
std::string clean_ascii(const char* text) {
  std::string out;
  const size_t n = std::strlen(text);
  out.reserve(n);
  bool pending_space = false;
  for (size_t i = 0; i < n; ++i) {
    const char c = text[i];
    if (is_space(c)) {
      pending_space = !out.empty();
    } else {
      if (pending_space) out.push_back(' ');
      pending_space = false;
      out.push_back(lower(c));
    }
  }
  return out;
}

// Word-split with the reference regex's semantics on lowercased ASCII:
// contractions ('s 't 're 've 'm 'll 'd) first at a match start, then
// letter runs, single digits, punctuation runs.  (The special-token
// alternatives cannot occur: the wrapper rejects "<|".)
void split_words(const std::string& s, std::vector<std::string>& words) {
  static const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    if (s[i] == ' ') {
      ++i;
      continue;
    }
    if (s[i] == '\'') {
      size_t len = 0;
      // longest contraction first: 're/'ve/'ll (3) before 's/'t/'m/'d (2)?
      // The regex alternation is ordered 's|'t|'re|'ve|'m|'ll|'d and regex
      // alternation takes the FIRST match, not the longest — replicate by
      // testing in that exact order.
      for (const char* c : kContractions) {
        const size_t cl = std::strlen(c);
        if (i + cl <= n && s.compare(i, cl, c) == 0) {
          len = cl;
          break;
        }
      }
      if (len > 0) {
        words.emplace_back(s.substr(i, len));
        i += len;
        continue;
      }
    }
    if (is_letter(s[i])) {
      size_t j = i + 1;
      while (j < n && is_letter(s[j])) ++j;
      words.emplace_back(s.substr(i, j - i));
      i = j;
      continue;
    }
    if (is_digit(s[i])) {
      words.emplace_back(s.substr(i, 1));
      ++i;
      continue;
    }
    // punctuation run: anything not space/letter/digit (a contraction only
    // wins when the match STARTS at the apostrophe, so a run that reaches
    // one keeps going — same as the regex)
    size_t j = i;
    while (j < n && s[j] != ' ' && !is_letter(s[j]) && !is_digit(s[j])) ++j;
    words.emplace_back(s.substr(i, j - i));
    i = j;
  }
}

void encode_padded(Bpe& bpe, const char* text, int max_words, int32_t* out) {
  std::vector<std::string> words;
  const std::string cleaned = clean_ascii(text);
  split_words(cleaned, words);
  // SOT + tokens truncated to max_words-1 (incl. SOT) + EOT + pad-0
  int pos = 0;
  out[pos++] = bpe.sot_id;
  bool full = false;
  for (const auto& w : words) {
    if (full) break;
    for (int id : encode_word(bpe, w)) {
      if (pos >= max_words - 1) {
        full = true;
        break;
      }
      out[pos++] = id;
    }
  }
  out[pos++] = bpe.eot_id;
  while (pos < max_words) out[pos++] = 0;
}

}  // namespace

extern "C" {

// Build a tokenizer from the decompressed merge table (exactly n_merges
// lines of "a b"; the caller strips the gzip header line).  Returns an
// opaque handle, or null if the table is malformed.
void* ccmh_bpe_create(const char* merges, int64_t len, int n_merges) {
  auto bpe = std::make_unique<Bpe>();
  std::vector<int> order;
  bpe->byte_sym = byte_symbols(order);

  std::vector<std::pair<std::string, std::string>> pairs;
  pairs.reserve(n_merges);
  const char* p = merges;
  const char* end = merges + len;
  while (p < end && static_cast<int>(pairs.size()) < n_merges) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* sp = static_cast<const char*>(memchr(p, ' ', line_end - p));
    if (sp == nullptr) return nullptr;
    pairs.emplace_back(std::string(p, sp), std::string(sp + 1, line_end));
    p = nl ? nl + 1 : end;
  }
  if (static_cast<int>(pairs.size()) != n_merges) return nullptr;

  bpe->rank.reserve(pairs.size());
  bpe->encoder.reserve(2 * 256 + pairs.size() + 2);
  int id = 0;
  for (int b : order) bpe->encoder.emplace(bpe->byte_sym[b], id++);
  for (int b : order) bpe->encoder.emplace(bpe->byte_sym[b] + "</w>", id++);
  for (size_t i = 0; i < pairs.size(); ++i) {
    bpe->rank.emplace(pairs[i].first + kSep + pairs[i].second,
                      static_cast<int>(i));
    bpe->encoder.emplace(pairs[i].first + pairs[i].second, id++);
  }
  bpe->sot_id = id++;
  bpe->eot_id = id++;
  bpe->encoder.emplace("<|startoftext|>", bpe->sot_id);
  bpe->encoder.emplace("<|endoftext|>", bpe->eot_id);
  return bpe.release();
}

void ccmh_bpe_destroy(void* handle) { delete static_cast<Bpe*>(handle); }

// texts[i] -> out[i * max_words : (i+1) * max_words] int32 padded ids.
// Caller guarantees the ASCII fast-path domain (see module comment).
int ccmh_bpe_encode_batch(void* handle, const char** texts, int n,
                          int max_words, int32_t* out, int n_threads) {
  Bpe& bpe = *static_cast<Bpe*>(handle);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      encode_padded(bpe, texts[i], max_words,
                    out + static_cast<size_t>(i) * max_words);
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
