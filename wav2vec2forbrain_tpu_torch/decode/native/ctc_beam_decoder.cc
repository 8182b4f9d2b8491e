// CTC beam-search decoder with ARPA n-gram LM rescoring (host-side, C++17).
//
// First-party replacement for the reference's pyctcdecode + kenlm stack
// (ref: src/train/evaluator.py:148-154,189-210 via HF
// Wav2Vec2ProcessorWithLM.batch_decode). The device produces log-probs; this
// library consumes them on the host, overlapped with the device's eval.
//
// Semantics follow pyctcdecode 0.5.0's prefix beam search (the version the
// reference pins), re-derived from its published algorithm:
//  - beams keyed by (text, partial_word, last_char); duplicates merged by
//    logsumexp of the acoustic score
//  - blank (id 0) and repeated-char frames extend a beam without emitting;
//    blank resets last_char so the same char can re-emit
//  - the word delimiter token moves the partial word into the text and
//    applies the LM:  score += alpha * ln(10) * (log10 P(w | ctx)
//    [+ unk_offset if w is not an LM unigram]) + beta
//  - the per-frame RANKING score additionally includes the partial-word
//    score: unk_offset * [partial is not a prefix of any LM unigram],
//    scaled by len/6 when the partial exceeds 6 chars (pyctcdecode
//    score_partial_token semantics; recomputed per frame, never accumulated)
//  - cumulative LM scores are cached PER TEXT: once a text's score is
//    cached it is never recomputed — including at end-of-sequence, where a
//    text first formed mid-stream keeps its cache entry WITHOUT the </s>
//    boundary score (a genuine pyctcdecode behavior, reproduced)
//  - token_min_logp: tokens below this per-frame score are skipped (the
//    frame argmax is always kept); beam_prune_logp: beams worse than
//    best + prune are dropped, then the top beam_width survive
//  - score_boundary: LM context starts at <s>; the trailing partial word is
//    completed at EOS and scored with </s> following; a transcript that
//    ends on a completed word gets no </s> score (pyctcdecode behavior)
//  - n-gram Katz-backoff scoring of an ARPA text model (arbitrary order);
//    stateless recompute over the last order-1 words == kenlm BaseScore
//
// Remaining divergences vs pyctcdecode (documented):
//  - special tokens (<s>, </s>, <unk>) are consumed without emitting;
//    pyctcdecode would append them to the partial word as literal chars
//  - the unigram set for OOV checks comes from the ARPA 1-gram section
//    (pyctcdecode takes an external unigrams list intersected with the LM)
//
// C ABI for ctypes; thread-parallel over the batch.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "kenlm_binary.h"

namespace {

constexpr float kNegInf = -1e30f;
constexpr double kLn10 = 2.302585092994046;

// --------------------------------------------------------- LM interface --

// Two interchangeable n-gram backends: ARPA text (NGramLM below) and the
// kenlm probing binary format (KenlmBinaryLM / native/kenlm_binary.h) — the
// format real LM artifacts for this benchmark ship in. Word ids live in the
// backend's own space; the decoder only threads them through score_word.
struct LanguageModel {
  int order = 0;
  int unk_id = -1, bos_id = -1, eos_id = -1;
  // 1-gram vocabulary, sorted, for pyctcdecode-style OOV / prefix checks
  std::vector<std::string> unigram_words;

  virtual ~LanguageModel() = default;
  virtual int word_id(const std::string& w) const = 0;
  // log10 P(w | context) with standard Katz backoff.
  virtual double score_word(const std::vector<int>& context, int w) const = 0;

  bool is_unigram(const std::string& w) const {
    return std::binary_search(unigram_words.begin(), unigram_words.end(), w);
  }

  // true iff some unigram starts with `p` (pygtrie has_node(p) != 0)
  bool has_unigram_prefix(const std::string& p) const {
    auto it =
        std::lower_bound(unigram_words.begin(), unigram_words.end(), p);
    return it != unigram_words.end() && it->compare(0, p.size(), p) == 0;
  }
};

// ---------------------------------------------------------------- ARPA LM --

struct NGramLM : LanguageModel {
  // key: space-joined word ids; value: (log10 prob, log10 backoff)
  struct Entry {
    double logp;
    double backoff;
  };
  std::unordered_map<std::string, int> word_ids;
  std::vector<std::unordered_map<std::string, Entry>> tables;  // [n-1]

  int word_id(const std::string& w) const override {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    return unk_id;
  }

  static std::string key(const std::vector<int>& ids, size_t start, size_t end) {
    std::string k;
    for (size_t i = start; i < end; ++i) {
      if (!k.empty()) k.push_back(' ');
      k += std::to_string(ids[i]);
    }
    return k;
  }

  double score_word(const std::vector<int>& context, int w) const override {
    std::vector<int> ids(context);
    ids.push_back(w);
    size_t total = ids.size();
    size_t maxn = std::min<size_t>(total, order);
    size_t start = total - maxn;
    // try longest n-gram first, accumulate backoff on misses
    double backoff_sum = 0.0;
    for (size_t s = start; s < total; ++s) {
      size_t n = total - s;
      const auto& table = tables[n - 1];
      auto it = table.find(key(ids, s, total));
      if (it != table.end()) return it->second.logp + backoff_sum;
      // miss at this order: add backoff weight of the (shorter) context
      // (context of order n-1 = ids[s..total-1))
      if (n >= 2) {
        const auto& ctx_table = tables[n - 2];
        auto bit = ctx_table.find(key(ids, s, total - 1));
        if (bit != ctx_table.end()) backoff_sum += bit->second.backoff;
      }
    }
    return -7.0 + backoff_sum;  // OOV floor (log10), pyctcdecode-style harsh
  }

  bool load_arpa(const std::string& path, std::string* err) {
    std::ifstream f(path);
    if (!f) {
      *err = "cannot open " + path;
      return false;
    }
    std::string line;
    // header
    std::vector<long> counts;
    while (std::getline(f, line)) {
      if (line.rfind("\\data\\", 0) == 0) break;
    }
    while (std::getline(f, line)) {
      if (line.empty()) continue;
      if (line[0] == '\\') break;  // first "\1-grams:" section marker
      if (line.rfind("ngram", 0) == 0) {
        auto eq = line.find('=');
        if (eq != std::string::npos)
          counts.push_back(std::stol(line.substr(eq + 1)));
      }
    }
    if (counts.empty()) {
      *err = "no ngram counts in ARPA header";
      return false;
    }
    order = static_cast<int>(counts.size());
    tables.resize(order);
    int next_word_id = 0;
    auto intern = [&](const std::string& w) {
      auto it = word_ids.find(w);
      if (it != word_ids.end()) return it->second;
      word_ids.emplace(w, next_word_id);
      return next_word_id++;
    };
    // `line` currently holds "\1-grams:" (or similar)
    int current_n = 0;
    do {
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line.rfind("\\end\\", 0) == 0) break;
        // parse "\N-grams:"
        auto dash = line.find('-');
        if (dash != std::string::npos && dash > 1) {
          current_n = std::stoi(line.substr(1, dash - 1));
        }
        continue;
      }
      if (current_n < 1) continue;
      // entry: logp \t w1 w2 ... wn [\t backoff]
      std::istringstream ss(line);
      double logp;
      if (!(ss >> logp)) continue;
      std::vector<int> ids;
      ids.reserve(current_n);
      std::string w;
      for (int i = 0; i < current_n; ++i) {
        if (!(ss >> w)) break;
        ids.push_back(intern(w));
      }
      if (static_cast<int>(ids.size()) != current_n) continue;
      if (current_n == 1 && w != "<s>" && w != "</s>" && w != "<unk>" &&
          w != "<UNK>")
        unigram_words.push_back(w);
      double backoff = 0.0;
      ss >> backoff;  // optional
      tables[current_n - 1][key(ids, 0, ids.size())] = {logp, backoff};
    } while (std::getline(f, line));

    auto find_id = [&](const char* w) {
      auto it = word_ids.find(w);
      return it == word_ids.end() ? -1 : it->second;
    };
    unk_id = find_id("<unk>");
    if (unk_id < 0) unk_id = find_id("<UNK>");
    bos_id = find_id("<s>");
    eos_id = find_id("</s>");
    std::sort(unigram_words.begin(), unigram_words.end());
    return true;
  }
};

// ------------------------------------------------------ kenlm binary LM --

// Adapter over the probing-format reader (kenlm_binary.h). Word ids are the
// kenlm vocab indices (<unk> = 0); the unigram set for pyctcdecode-style
// OOV/prefix checks comes from the binary's embedded vocabulary strings —
// richer than pyctcdecode, which cannot extract unigrams from a binary LM
// at all and decodes with an empty unigram set unless given unigrams.txt.
struct KenlmBinaryLM : LanguageModel {
  kenlm_binary::KenlmBinaryModel model;

  bool load(const std::string& path, std::string* err) {
    if (!model.load(path, err)) return false;
    order = model.order;
    unk_id = 0;
    for (uint32_t id = 1; id < model.words.size(); ++id) {
      const std::string& w = model.words[id];
      if (w == "<s>") {
        bos_id = static_cast<int>(id);
      } else if (w == "</s>") {
        eos_id = static_cast<int>(id);
      } else {
        unigram_words.push_back(w);
      }
    }
    std::sort(unigram_words.begin(), unigram_words.end());
    return true;
  }

  int word_id(const std::string& w) const override {
    return model.word_id(w);
  }

  double score_word(const std::vector<int>& context, int w) const override {
    return model.score_word(context, w);
  }
};

// ----------------------------------------------------------- beam search --

// Prefix arena: beams reference interned character chains instead of owning
// strings, so a beam is a small POD and the per-frame expansion loop does no
// heap traffic. Node 0 is the empty prefix.
struct PrefixArena {
  struct Node {
    int32_t parent;
    char ch;
  };
  std::vector<Node> nodes{{-1, '\0'}};

  int32_t extend(int32_t node, char ch) {
    nodes.push_back({node, ch});
    return static_cast<int32_t>(nodes.size() - 1);
  }

  std::string materialize(int32_t node) const {
    std::string out;
    while (node > 0) {
      out.push_back(nodes[node].ch);
      node = nodes[node].parent;
    }
    std::reverse(out.begin(), out.end());
    return out;
  }
};

constexpr int kMaxCtx = 8;  // supports up to 9-gram LMs

struct Beam {
  int32_t text = 0;     // arena id: completed words (space-joined)
  int32_t partial = 0;  // arena id: in-progress word
  int last_char = -1;   // last emitted vocab idx (-1 = "blank" sentinel)
  double p_ac = 0.0;    // acoustic log score (logsumexp-merged, f64 like numpy)
  double rank = 0.0;    // p_ac + cached text LM score + partial score
};

// Cumulative LM score for a completed-words text, cached per text node —
// pyctcdecode keys its lm score cache by the text string; arena nodes are
// hash-consed so node identity == string identity.
struct LMEntry {
  double score = 0.0;  // cumulative, ln-domain, alpha/beta applied
  int32_t ctx[kMaxCtx];
  uint8_t ctx_len = 0;
};

struct Decoder {
  std::vector<std::string> vocab;  // index -> token string
  int blank_id = 0;
  int delim_id = -1;               // word delimiter ("|" -> space)
  std::vector<bool> special;      // tokens like <s> </s> <unk>: never emitted
  std::unique_ptr<LanguageModel> lm;
  double alpha = 0.5, beta = 0.5;
  double unk_offset = -10.0;  // pyctcdecode DEFAULT_UNK_LOGP_OFFSET
  bool score_boundary = false;
};

constexpr int kAvgTokenLen = 6;  // pyctcdecode AVG_TOKEN_LEN

inline double logsumexp2(double a, double b) {
  if (a < b) std::swap(a, b);
  if (b <= kNegInf) return a;
  return a + std::log1p(std::exp(b - a));
}

// Per-sequence decode state: the prefix arena plus the LM/partial caches.
struct DecodeState {
  PrefixArena arena;
  std::unordered_map<uint64_t, int32_t> extend_cache;
  std::unordered_map<int32_t, LMEntry> lm_cache;       // text node -> score
  std::unordered_map<int32_t, double> partial_cache;   // partial node -> score

  int32_t extend_cached(const Decoder& d, int32_t node, int v) {
    uint64_t key =
        (static_cast<uint64_t>(node) << 16) | static_cast<uint32_t>(v);
    auto it = extend_cache.find(key);
    if (it != extend_cache.end()) return it->second;
    int32_t nn = node;
    for (char c : d.vocab[v]) nn = arena.extend(nn, c);
    extend_cache.emplace(key, nn);
    return nn;
  }

  // splice a completed word onto a text node (hash-consed through the same
  // extension cache so equal strings always share one node)
  int32_t splice(const Decoder& d, int32_t text, int32_t partial) {
    std::string word = arena.materialize(partial);
    int32_t node = text;
    auto extend_ch = [&](int32_t n, char c) {
      uint64_t key = (static_cast<uint64_t>(n) << 16) |
                     (0x8000u | static_cast<uint8_t>(c));
      auto it = extend_cache.find(key);
      if (it != extend_cache.end()) return it->second;
      int32_t nn = arena.extend(n, c);
      extend_cache.emplace(key, nn);
      return nn;
    };
    if (node != 0) node = extend_ch(node, ' ');
    for (char c : word) node = extend_ch(node, c);
    return node;
  }

  // pyctcdecode score_partial_token: pure OOV penalty on the in-progress
  // word, recomputed per frame for ranking, never accumulated.
  double partial_score(const Decoder& d, int32_t partial) {
    if (partial == 0 || !d.lm) return 0.0;
    auto it = partial_cache.find(partial);
    if (it != partial_cache.end()) return it->second;
    std::string p = arena.materialize(partial);
    double unk = d.unk_offset * (d.lm->has_unigram_prefix(p) ? 0.0 : 1.0);
    if (p.size() > kAvgTokenLen)
      unk = unk * static_cast<double>(p.size()) / kAvgTokenLen;
    partial_cache.emplace(partial, unk);
    return unk;
  }

  // Complete beam.partial into beam.text, ensuring the new text's cumulative
  // LM score is cached. Once cached a text score is FINAL — the is_last
  // boundary score only lands if this completion created the entry
  // (pyctcdecode caches by text and skips recompute at EOS).
  void complete_word(const Decoder& d, Beam& b, bool is_last) {
    if (b.partial == 0) return;
    int32_t new_text = splice(d, b.text, b.partial);
    if (d.lm && lm_cache.find(new_text) == lm_cache.end()) {
      auto pit = lm_cache.find(b.text);
      const LMEntry prev = pit == lm_cache.end() ? LMEntry{} : pit->second;
      std::string word = arena.materialize(b.partial);
      int wid = d.lm->word_id(word);
      std::vector<int> ctx(prev.ctx, prev.ctx + prev.ctx_len);
      double raw = d.lm->score_word(ctx, wid);  // log10, backoff
      if (!d.lm->is_unigram(word)) raw += d.unk_offset;
      LMEntry e;
      int maxc = std::min(std::max(d.lm->order - 1, 1), kMaxCtx);
      int keep = std::min<int>(prev.ctx_len, maxc - 1);
      int drop = prev.ctx_len - keep;
      for (int i = 0; i < keep; ++i) e.ctx[i] = prev.ctx[drop + i];
      e.ctx[keep] = wid;
      e.ctx_len = static_cast<uint8_t>(keep + 1);
      if (is_last && d.score_boundary && d.lm->eos_id >= 0) {
        std::vector<int> ctx2(e.ctx, e.ctx + e.ctx_len);
        raw += d.lm->score_word(ctx2, d.lm->eos_id);
      }
      e.score = prev.score + d.alpha * kLn10 * raw + d.beta;
      lm_cache.emplace(new_text, e);
    }
    b.text = new_text;
    b.partial = 0;
  }

  double text_score(int32_t text) const {
    auto it = lm_cache.find(text);
    return it == lm_cache.end() ? 0.0 : it->second.score;
  }
};

std::string decode_one(const Decoder& d, const float* logp, int T, int V,
                       int beam_width, float prune_logp, float token_min_logp) {
  DecodeState st;
  {
    LMEntry root;
    if (d.lm && d.score_boundary && d.lm->bos_id >= 0) {
      root.ctx[0] = d.lm->bos_id;
      root.ctx_len = 1;
    }
    st.lm_cache.emplace(0, root);
  }
  std::vector<Beam> beams(1);

  auto rank_and_prune = [&](std::vector<Beam>& uniq) {
    if (uniq.empty()) return;
    double best = -1e300;
    for (Beam& b : uniq) {
      b.rank = b.p_ac + st.text_score(b.text) + st.partial_score(d, b.partial);
      best = std::max(best, b.rank);
    }
    // pyctcdecode order: outlier filter (>= best + prune) then top-k
    uniq.erase(std::remove_if(uniq.begin(), uniq.end(),
                              [&](const Beam& b) {
                                return b.rank < best + prune_logp;
                              }),
               uniq.end());
    std::sort(uniq.begin(), uniq.end(),
              [](const Beam& a, const Beam& b) { return a.rank > b.rank; });
    if (static_cast<int>(uniq.size()) > beam_width) uniq.resize(beam_width);
  };

  std::vector<Beam> next;
  std::unordered_map<uint64_t, size_t> merged;
  auto merge = [&](std::vector<Beam>& in, std::vector<Beam>& out) {
    merged.clear();
    out.clear();
    out.reserve(in.size());
    for (Beam& b : in) {
      uint64_t k =
          (static_cast<uint64_t>(static_cast<uint32_t>(b.text)) << 32) |
          (static_cast<uint64_t>(static_cast<uint32_t>(b.partial) & 0xFFFFFF)
           << 8) |
          static_cast<uint64_t>(static_cast<uint8_t>(b.last_char + 1));
      auto it = merged.find(k);
      if (it == merged.end()) {
        merged.emplace(k, out.size());
        out.push_back(b);
      } else {
        out[it->second].p_ac = logsumexp2(out[it->second].p_ac, b.p_ac);
      }
    }
  };

  std::vector<Beam> uniq;
  for (int t = 0; t < T; ++t) {
    const float* row = logp + static_cast<size_t>(t) * V;
    int max_idx = 0;
    for (int v = 1; v < V; ++v)
      if (row[v] > row[max_idx]) max_idx = v;

    next.clear();
    next.reserve(beams.size() * 8);
    for (int v = 0; v < V; ++v) {
      float p = row[v];
      if (v != max_idx && p < token_min_logp) continue;
      for (const Beam& b : beams) {
        Beam nb = b;  // POD copy
        nb.p_ac += p;
        if (v == d.blank_id) {
          nb.last_char = -1;
        } else if (v == b.last_char) {
          // repeat frame: same emission, no new char
        } else if (d.special[v]) {
          // special tokens (<s>, </s>, <unk>) consumed, emit nothing
          nb.last_char = v;
        } else if (v == d.delim_id) {
          st.complete_word(d, nb, /*is_last=*/false);
          nb.last_char = v;
        } else {
          nb.partial = st.extend_cached(d, b.partial, v);
          nb.last_char = v;
        }
        next.push_back(nb);
      }
    }
    merge(next, uniq);
    rank_and_prune(uniq);
    beams.swap(uniq);
    if (beams.empty()) break;
  }
  if (beams.empty()) return "";
  // EOS: complete trailing partial words (with boundary scoring), merge the
  // now-identical beams, re-rank
  for (Beam& b : beams) {
    st.complete_word(d, b, /*is_last=*/true);
    b.last_char = -1;  // merge on text alone at EOS like pyctcdecode
  }
  merge(beams, uniq);
  rank_and_prune(uniq);
  if (uniq.empty()) return "";
  return st.arena.materialize(uniq.front().text);
}

}  // namespace

extern "C" {

void* ctc_decoder_create(const char** vocab, int vocab_size, int blank_id,
                         const char* word_delim_token, const char* arpa_path,
                         double alpha, double beta, double unk_score_offset,
                         int score_boundary, char* err_out, int err_cap) {
  auto d = std::make_unique<Decoder>();
  d->vocab.assign(vocab, vocab + vocab_size);
  d->blank_id = blank_id;
  d->special.assign(vocab_size, false);
  for (int i = 0; i < vocab_size; ++i) {
    const std::string& tok = d->vocab[i];
    if (tok == word_delim_token) d->delim_id = i;
    if (tok.size() >= 2 && tok.front() == '<' && tok.back() == '>' &&
        i != blank_id)
      d->special[i] = true;
  }
  d->alpha = alpha;
  d->beta = beta;
  d->unk_offset = unk_score_offset;
  d->score_boundary = score_boundary != 0;
  if (arpa_path != nullptr && arpa_path[0] != '\0') {
    std::string err;
    if (kenlm_binary::KenlmBinaryModel::looks_like_kenlm_binary(arpa_path)) {
      auto lm = std::make_unique<KenlmBinaryLM>();
      if (!lm->load(arpa_path, &err)) {
        std::snprintf(err_out, err_cap, "%s", err.c_str());
        return nullptr;
      }
      d->lm = std::move(lm);
    } else {
      auto lm = std::make_unique<NGramLM>();
      if (!lm->load_arpa(arpa_path, &err)) {
        std::snprintf(err_out, err_cap, "%s", err.c_str());
        return nullptr;
      }
      d->lm = std::move(lm);
    }
  }
  return d.release();
}

void ctc_decoder_destroy(void* handle) {
  delete static_cast<Decoder*>(handle);
}

int ctc_decoder_lm_order(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  return d->lm ? d->lm->order : 0;
}

// logp: (B, T, V) float32 natural-log probabilities; lens: (B,) valid frames.
// out: caller-allocated char* array of size B; each entry malloc'd here,
// caller frees via ctc_decoder_free_strings.
void ctc_decoder_decode_batch(void* handle, const float* logp, int B, int T,
                              int V, const int* lens, int beam_width,
                              float prune_logp, float token_min_logp,
                              char** out, int n_threads) {
  auto* d = static_cast<Decoder*>(handle);
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, B));
  auto work = [&](int start, int stride) {
    for (int b = start; b < B; b += stride) {
      int tlen = lens ? std::min(lens[b], T) : T;
      std::string s =
          decode_one(*d, logp + static_cast<size_t>(b) * T * V, tlen, V,
                     beam_width, prune_logp, token_min_logp);
      out[b] = static_cast<char*>(std::malloc(s.size() + 1));
      std::memcpy(out[b], s.c_str(), s.size() + 1);
    }
  };
  if (n_threads == 1) {
    work(0, 1);
  } else {
    std::vector<std::thread> threads;
    for (int i = 0; i < n_threads; ++i) threads.emplace_back(work, i, n_threads);
    for (auto& th : threads) th.join();
  }
}

void ctc_decoder_free_strings(char** strs, int n) {
  for (int i = 0; i < n; ++i) std::free(strs[i]);
}

}  // extern "C"
