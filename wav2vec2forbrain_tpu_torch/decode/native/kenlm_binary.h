// KenLM probing-format binary n-gram model reader (header-only, C++17).
//
// The reference decodes with pyctcdecode + kenlm, and real LM artifacts for
// this benchmark ship as kenlm *binary* models (the ARPA text is often not
// distributed). This is a first-party reader for the PROBING model type —
// the default output of kenlm's `build_binary` — implemented from the
// published on-disk format (kenlm lm/binary_format.{hh,cc}, lm/vocab.{hh,cc},
// lm/search_hashed.hh, util/probing_hash_table.hh, util/murmur_hash.cc):
//
//   [Sanity 88B]  magic "mmap lm http://kheafield.com/code format version 5"
//                 + reference values (0.0f, 1.0f, -0.5f, 1u, ~0u, 1ull)
//   [FixedWidthParameters 20B] order u8, probing_multiplier f32,
//                 model_type i32, has_vocabulary u8, search_version u32
//   [counts]      order x u64, then ALIGN8
//   [vocab]       8B header {u32 version, u32 bound} + probing hash table of
//                 12B entries {u64 murmur64a(word), u32 word_id}; <unk> is
//                 id 0 and is NOT in the table
//   [unigram]     (counts[0]+1) x {f32 log10 prob, f32 log10 backoff},
//                 indexed by word id
//   [middle n]    for n = 2..order-1: probing hash table of 16B entries
//                 {u64 chained_hash, f32 prob, f32 backoff}
//   [longest]     probing hash table of 12B entries {u64 chained_hash, f32 prob}
//   [strings]     iff has_vocabulary: the words, NUL-separated, in id order
//                 starting with "<unk>", running to EOF
//
// Hash chain for an n-gram (w1..wn, oldest..newest), kenlm CombineWordHash:
//   h = wn;  for i = n-1 .. 1:  h = (h * 8978948897894561157) ^
//                                   ((1 + w_i) * 17894857484156487943)
// Probing tables: bucket = h % buckets, linear probe, wraparound, empty = 0,
// buckets = max(entries + 1, (u64)(multiplier * (float)entries)).
//
// Because kenlm itself cannot be vendored here, the layout is additionally
// validated at load: the magic/reference values must match, the section
// arithmetic must land exactly on EOF, the strings section must contain
// `bound` words starting with "<unk>", and every word's murmur hash must
// resolve through the vocab table to its own id (with an 8-byte-alignment
// probe between sections in case of writer padding differences). A file that
// fails validation is rejected with a precise error instead of mis-scoring.
//
// TRIE / quantized / REST model types are rejected with a message suggesting
// `build_binary probing` or the ARPA text path.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace kenlm_binary {

inline uint64_t murmur_hash64a(const void* key, size_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const uint8_t* data = static_cast<const uint8_t*>(key);
  size_t n8 = len / 8;
  for (size_t i = 0; i < n8; ++i) {
    uint64_t k;
    std::memcpy(&k, data + i * 8, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  const uint8_t* tail = data + n8 * 8;
  switch (len & 7) {
    case 7: h ^= static_cast<uint64_t>(tail[6]) << 48; [[fallthrough]];
    case 6: h ^= static_cast<uint64_t>(tail[5]) << 40; [[fallthrough]];
    case 5: h ^= static_cast<uint64_t>(tail[4]) << 32; [[fallthrough]];
    case 4: h ^= static_cast<uint64_t>(tail[3]) << 24; [[fallthrough]];
    case 3: h ^= static_cast<uint64_t>(tail[2]) << 16; [[fallthrough]];
    case 2: h ^= static_cast<uint64_t>(tail[1]) << 8; [[fallthrough]];
    case 1: h ^= static_cast<uint64_t>(tail[0]); h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

inline uint64_t hash_for_vocab(const std::string& w) {
  return murmur_hash64a(w.data(), w.size(), 0);
}

inline uint64_t combine_word_hash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ULL) ^
         (static_cast<uint64_t>(1 + next) * 17894857484156487943ULL);
}

inline uint64_t align8(uint64_t x) { return (x + 7) / 8 * 8; }

inline uint64_t bucket_count(uint64_t entries, float multiplier) {
  return std::max<uint64_t>(
      entries + 1,
      static_cast<uint64_t>(multiplier * static_cast<float>(entries)));
}

constexpr char kMagicPrefix[] = "mmap lm http://kheafield.com/code format version";
constexpr size_t kSanityBytes = 88;
constexpr size_t kFixedParamsBytes = 20;

struct KenlmBinaryModel {
  int order = 0;
  uint32_t bound = 0;  // number of words incl <unk> (= highest id + 1)
  float multiplier = 1.5f;
  std::vector<uint64_t> counts;
  std::vector<std::string> words;  // id -> string

  ~KenlmBinaryModel() {
    if (map_ != nullptr && map_ != MAP_FAILED) munmap(map_, map_size_);
  }
  KenlmBinaryModel() = default;
  KenlmBinaryModel(const KenlmBinaryModel&) = delete;
  KenlmBinaryModel& operator=(const KenlmBinaryModel&) = delete;

  // Cheap magic sniff so the caller can route .bin vs ARPA automatically.
  static bool looks_like_kenlm_binary(const std::string& path) {
    std::FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    char buf[sizeof(kMagicPrefix)] = {0};
    size_t got = std::fread(buf, 1, sizeof(kMagicPrefix) - 1, f);
    std::fclose(f);
    return got == sizeof(kMagicPrefix) - 1 &&
           std::memcmp(buf, kMagicPrefix, sizeof(kMagicPrefix) - 1) == 0;
  }

  bool load(const std::string& path, std::string* err) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) {
      *err = "cannot open " + path;
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (long)(kSanityBytes + kFixedParamsBytes)) {
      ::close(fd);
      *err = "kenlm binary too small / unreadable: " + path;
      return false;
    }
    map_size_ = static_cast<size_t>(st.st_size);
    map_ = mmap(nullptr, map_size_, PROT_READ, MAP_SHARED, fd, 0);
    ::close(fd);
    if (map_ == MAP_FAILED) {
      map_ = nullptr;
      *err = "mmap failed for " + path;
      return false;
    }
    base_ = static_cast<const uint8_t*>(map_);
    return parse(err);
  }

  int word_id(const std::string& w) const {
    uint64_t h = hash_for_vocab(w);
    uint64_t b = vocab_buckets_;
    uint64_t i = h % b;
    // probe at most `b` slots: a table with no empty slot (possible only in
    // a corrupt file — validation keeps real tables under-full) must not
    // spin forever
    for (uint64_t n = 0; n < b; ++n) {
      uint64_t key = read_u64(vocab_table_ + i * 12);
      if (key == h) return static_cast<int>(read_u32(vocab_table_ + i * 12 + 8));
      if (key == 0) return 0;  // <unk>
      if (++i == b) i = 0;
    }
    return 0;
  }

  // log10 P(w | context) with Katz backoff — same recursion as the ARPA
  // backend; ids are kenlm vocab indices.
  double score_word(const std::vector<int>& context, int w) const {
    size_t clen = context.size();
    size_t total = clen + 1;
    size_t maxn = std::min<size_t>(total, static_cast<size_t>(order));
    size_t start = total - maxn;
    auto id_at = [&](size_t i) -> uint32_t {
      return static_cast<uint32_t>(i < clen ? context[i] : w);
    };
    double backoff_sum = 0.0;
    for (size_t s = start; s < total; ++s) {
      size_t n = total - s;
      if (n == 1) {
        uint32_t id = id_at(total - 1);
        if (id < bound)
          return read_f32(unigram_ + id * 8) + backoff_sum;
        return -7.0 + backoff_sum;  // invalid id; cannot happen via word_id()
      }
      uint64_t h = id_at(total - 1);
      for (size_t i = total - 1; i > s;) h = combine_word_hash(h, id_at(--i));
      if (n == static_cast<size_t>(order)) {
        const uint8_t* e = find(longest_table_, longest_buckets_, 12, h);
        if (e) return read_f32(e + 8) + backoff_sum;
      } else {
        const uint8_t* e =
            find(middle_tables_[n - 2], middle_buckets_[n - 2], 16, h);
        if (e) return read_f32(e + 8) + backoff_sum;
      }
      // miss: accumulate backoff of the context ids[s..total-1)
      size_t bn = n - 1;
      if (bn == 1) {
        backoff_sum += read_f32(unigram_ + id_at(s) * 8 + 4);
      } else {
        uint64_t hb = id_at(total - 2);
        for (size_t i = total - 2; i > s;) hb = combine_word_hash(hb, id_at(--i));
        const uint8_t* e =
            find(middle_tables_[bn - 2], middle_buckets_[bn - 2], 16, hb);
        if (e) backoff_sum += read_f32(e + 12);
      }
    }
    return -7.0 + backoff_sum;
  }

 private:
  void* map_ = nullptr;
  size_t map_size_ = 0;
  const uint8_t* base_ = nullptr;
  const uint8_t* vocab_table_ = nullptr;
  uint64_t vocab_buckets_ = 0;
  const uint8_t* unigram_ = nullptr;
  std::vector<const uint8_t*> middle_tables_;
  std::vector<uint64_t> middle_buckets_;
  const uint8_t* longest_table_ = nullptr;
  uint64_t longest_buckets_ = 0;

  static uint64_t read_u64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
  }
  static uint32_t read_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
  }
  static float read_f32(const uint8_t* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
  }

  const uint8_t* find(const uint8_t* table, uint64_t buckets,
                      uint32_t entry_size, uint64_t h) const {
    uint64_t i = h % buckets;
    // bounded probe (see word_id): a full table terminates after one sweep
    for (uint64_t n = 0; n < buckets; ++n) {
      const uint8_t* e = table + i * entry_size;
      uint64_t key = read_u64(e);
      if (key == h) return e;
      if (key == 0) return nullptr;
      if (++i == buckets) i = 0;
    }
    return nullptr;
  }

  bool parse(std::string* err) {
    // --- Sanity header ---
    if (std::memcmp(base_, kMagicPrefix, sizeof(kMagicPrefix) - 1) != 0) {
      *err = "not a kenlm binary (magic mismatch)";
      return false;
    }
    // "... format version N\n" — N must be 5
    const char* ver = reinterpret_cast<const char*>(base_) +
                      sizeof(kMagicPrefix) - 1;
    long version = std::strtol(ver, nullptr, 10);
    if (version != 5) {
      *err = "kenlm binary format version " + std::to_string(version) +
             " unsupported (expected 5; rebuild with a current build_binary)";
      return false;
    }
    float zero_f = read_f32(base_ + 56), one_f = read_f32(base_ + 60),
          mhalf_f = read_f32(base_ + 64);
    uint32_t one_w = read_u32(base_ + 68), max_w = read_u32(base_ + 72);
    uint64_t one_u64 = read_u64(base_ + 80);
    if (zero_f != 0.0f || one_f != 1.0f || mhalf_f != -0.5f || one_w != 1u ||
        max_w != 0xFFFFFFFFu || one_u64 != 1ull) {
      *err = "kenlm binary sanity values mismatch (incompatible platform or "
             "layout)";
      return false;
    }
    // --- FixedWidthParameters ---
    const uint8_t* p = base_ + kSanityBytes;
    order = p[0];
    std::memcpy(&multiplier, p + 4, 4);
    int32_t model_type;
    std::memcpy(&model_type, p + 8, 4);
    bool has_vocab = p[12] != 0;
    if (order < 1 || order > 16) {
      *err = "kenlm binary: implausible order " + std::to_string(order);
      return false;
    }
    if (model_type != 0) {
      static const char* kNames[] = {"PROBING",    "REST_PROBING", "TRIE",
                                     "QUANT_TRIE", "ARRAY_TRIE",
                                     "QUANT_ARRAY_TRIE"};
      std::string name = (model_type >= 0 && model_type < 6)
                             ? kNames[model_type]
                             : std::to_string(model_type);
      *err = "kenlm binary model type " + name +
             " not supported; rebuild with `build_binary probing in.arpa "
             "out.bin` or pass the ARPA text model";
      return false;
    }
    if (!has_vocab) {
      *err = "kenlm binary was built without the vocabulary strings "
             "(build_binary without vocab); rebuild with the default "
             "settings or pass the ARPA text model";
      return false;
    }
    if (!(multiplier >= 1.0f) || multiplier > 100.0f) {
      *err = "kenlm binary: implausible probing multiplier";
      return false;
    }
    counts.assign(order, 0);
    const uint8_t* c = base_ + kSanityBytes + kFixedParamsBytes;
    for (int i = 0; i < order; ++i) counts[i] = read_u64(c + 8 * i);
    // every table entry is >= 8 bytes, so any count beyond map_size_/8
    // cannot fit in the file; rejecting it here also keeps the
    // bucket_count()*entry_size products in try_layout from wrapping u64
    for (int i = 0; i < order; ++i) {
      if (counts[i] == 0 || counts[i] > map_size_ / 8) {
        *err = "kenlm binary: implausible n-gram count " +
               std::to_string(counts[i]) + " for order " + std::to_string(i + 1);
        return false;
      }
    }
    uint64_t data_start =
        align8(kSanityBytes + kFixedParamsBytes + 8ull * order);

    // --- section arithmetic, with an alignment probe: candidate 0 is the
    // canonical straight-sum layout; candidate 1 ALIGN8s each section
    // boundary, covering writers that realign sections. Validation (string
    // count, <unk> first, per-word hash round-trip) rejects a wrong guess.
    std::string err0;
    if (try_layout(data_start, /*align_sections=*/false, &err0)) return true;
    std::string err1;
    if (try_layout(data_start, /*align_sections=*/true, &err1)) return true;
    *err = "kenlm binary layout validation failed (" + err0 +
           "; aligned-layout retry: " + err1 + ")";
    return false;
  }

  bool try_layout(uint64_t data_start, bool align_sections, std::string* err) {
    err->clear();
    // Overflow-safe cursor advance: rejects any section whose extent would
    // wrap uint64 or run past the mapping, BEFORE table pointers derived
    // from `off` are ever dereferenced (counts[] comes straight from the
    // file, so rows*entry_size is attacker-controlled arithmetic).
    auto take = [&](uint64_t* off, uint64_t rows, uint64_t entry_size,
                    const char* what) {
      if (*off > map_size_ || rows > (map_size_ - *off) / entry_size) {
        *err = std::string(what) + " table exceeds file size";
        return false;
      }
      *off += rows * entry_size;
      if (align_sections) *off = align8(*off);
      return true;
    };
    uint64_t off = data_start;
    // vocab: 8-byte header {version, bound} + table
    if (off + 8 > map_size_) {
      *err = "truncated vocab header";
      return false;
    }
    uint32_t va = read_u32(base_ + off), vb = read_u32(base_ + off + 4);
    // one field is the format version (small), the other the word bound
    // (== counts[0] when <unk> is listed, else counts[0]+1)
    uint64_t c0 = counts[0];
    if (vb == c0 || vb == c0 + 1) {
      bound = vb;
    } else if (va == c0 || va == c0 + 1) {
      bound = va;
    } else {
      *err = "vocab bound (" + std::to_string(va) + "/" + std::to_string(vb) +
             ") does not match unigram count " + std::to_string(c0);
      return false;
    }
    off += 8;
    vocab_table_ = base_ + off;
    vocab_buckets_ = bucket_count(c0, multiplier);
    if (!take(&off, vocab_buckets_, 12, "vocab")) return false;
    // unigram array
    unigram_ = base_ + off;
    if (!take(&off, c0 + 1, 8, "unigram")) return false;
    // middles
    middle_tables_.clear();
    middle_buckets_.clear();
    for (int n = 2; n < order; ++n) {
      middle_tables_.push_back(base_ + off);
      middle_buckets_.push_back(bucket_count(counts[n - 1], multiplier));
      if (!take(&off, middle_buckets_.back(), 16, "middle")) return false;
    }
    // longest
    longest_table_ = nullptr;
    longest_buckets_ = 0;
    if (order >= 2) {
      longest_table_ = base_ + off;
      longest_buckets_ = bucket_count(counts[order - 1], multiplier);
      if (!take(&off, longest_buckets_, 12, "longest")) return false;
    }
    // strings to EOF
    const char* s = reinterpret_cast<const char*>(base_ + off);
    size_t remain = map_size_ - off;
    words.clear();
    words.reserve(bound);
    size_t i = 0;
    while (i < remain && words.size() < bound) {
      size_t j = i;
      while (j < remain && s[j] != '\0') ++j;
      if (j >= remain) break;  // unterminated
      words.emplace_back(s + i, j - i);
      i = j + 1;
    }
    if (words.size() != bound ||
        (i != remain && !all_zero(s + i, remain - i))) {
      *err = "vocabulary strings section mismatch (expected " +
             std::to_string(bound) + " words)";
      words.clear();
      return false;
    }
    if (words.empty() || (words[0] != "<unk>" && words[0] != "<UNK>")) {
      *err = "vocabulary strings do not start with <unk>";
      words.clear();
      return false;
    }
    // strong validation: every word's hash must resolve to its own id
    // through the vocab table (word 0 = <unk> is not in the table)
    for (uint32_t id = 1; id < bound; ++id) {
      if (static_cast<uint32_t>(word_id(words[id])) != id) {
        *err = "vocab hash table lookup mismatch for word " +
               std::to_string(id);
        words.clear();
        return false;
      }
    }
    return true;
  }

  static bool all_zero(const char* p, size_t n) {
    for (size_t i = 0; i < n; ++i)
      if (p[i] != '\0') return false;
    return true;
  }
};

}  // namespace kenlm_binary
