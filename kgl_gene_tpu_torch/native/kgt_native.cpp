// kgt_native — native host-ingest kernels.
//
// Copy of kgl_gene_tpu/native/kgt_native.cpp for the PyTorch port, with one
// change: radix_sort_keys skips a pass when one byte bucket holds every key
// summed over the workers (the original tested one worker's count, so with
// more than one worker the skip never fired). The sort's output is the same.
//
// Capability parity with the reference's native ingest hot path:
//   - BGZF parallel-block decompression (kel_io/kel_bzip_workflow.h:42:
//     1 reader -> N zlib inflate threads -> ordered output)
//   - VCF genotype-column tokenisation (the per-record x per-sample
//     GT/AD/DP/GQ split that the reference runs on 50 consumer threads,
//     kgl_parser/kgl_variant_factory_pf_impl.cpp:110-380)
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libkgt_native.so kgt_native.cpp -lz -lpthread
// (kgl_gene_tpu_torch/native/__init__.py builds it on first use).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <future>
#include <limits>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------
struct BgzfBlock {
  std::vector<uint8_t> compressed;  // deflate payload (no header/footer)
  uint32_t isize = 0;
  uint32_t crc32_expect = 0;
};

// Parse BGZF blocks out of a raw file image. Returns false on framing error.
bool split_blocks(const uint8_t* data, size_t size, std::vector<BgzfBlock>& blocks) {
  size_t pos = 0;
  while (pos + 18 <= size) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
    uint16_t xlen = static_cast<uint16_t>(data[pos + 10]) |
                    (static_cast<uint16_t>(data[pos + 11]) << 8);
    // find BC subfield for BSIZE
    size_t extra = pos + 12;
    size_t extra_end = extra + xlen;
    if (extra_end > size) return false;
    uint32_t bsize = 0;
    size_t sub = extra;
    while (sub + 4 <= extra_end) {
      uint8_t si1 = data[sub], si2 = data[sub + 1];
      uint16_t slen = static_cast<uint16_t>(data[sub + 2]) |
                      (static_cast<uint16_t>(data[sub + 3]) << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        bsize = (static_cast<uint32_t>(data[sub + 4]) |
                 (static_cast<uint32_t>(data[sub + 5]) << 8)) + 1;
      }
      sub += 4 + slen;
    }
    if (bsize == 0 || pos + bsize > size) return false;
    size_t comp_begin = extra_end;
    size_t comp_end = pos + bsize - 8;  // crc32 + isize trailer
    BgzfBlock block;
    block.compressed.assign(data + comp_begin, data + comp_end);
    std::memcpy(&block.crc32_expect, data + comp_end, 4);
    std::memcpy(&block.isize, data + comp_end + 4, 4);
    blocks.push_back(std::move(block));
    pos += bsize;
  }
  return pos == size;
}

bool inflate_block(const BgzfBlock& block, uint8_t* out) {
  if (block.isize == 0) return true;
  z_stream zs{};
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(block.compressed.data());
  zs.avail_in = static_cast<uInt>(block.compressed.size());
  zs.next_out = out;
  zs.avail_out = block.isize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == block.isize;
}

// Parse a GT field into allele parts, matching io/vcf.py::_parse_gt
// exactly: '|' anywhere selects the phased separator, '.' or empty tokens
// become allele 0, any other non-digit content invalidates the whole field
// (Python returns None -> the sample is skipped). Returns the part count,
// or -1 for missing/invalid GT. Shared by the per-record genotype tokenizer
// and the end-to-end record-loop parser so the two paths can never diverge.
constexpr int kMaxGtParts = 8;

inline int parse_gt_parts(const char* p, const char* end, int64_t* parts,
                          bool& phased) {
  phased = false;
  if (p >= end) return -1;                    // empty -> skip sample
  if (end - p == 1 && *p == '.') return -1;   // '.' -> skip sample
  for (const char* q = p; q < end; ++q) {
    if (*q == '|') {
      phased = true;
      break;
    }
  }
  const char sep = phased ? '|' : '/';
  int n = 0;
  const char* tok = p;
  for (const char* q = p;; ++q) {
    if (q == end || *q == sep) {
      if (n >= kMaxGtParts) return -1;
      int64_t v = 0;
      if (q == tok || (q - tok == 1 && *tok == '.')) {
        v = 0;  // missing token -> ref allele (parity with _parse_gt)
      } else {
        for (const char* c = tok; c < q; ++c) {
          if (*c < '0' || *c > '9') return -1;  // non-digit -> skip sample
          v = v * 10 + (*c - '0');
        }
      }
      parts[n++] = v;
      if (q == end) break;
      tok = q + 1;
    }
  }
  return n;
}

// Like split_blocks, but tolerates a trailing PARTIAL block: frames every
// complete block and reports how many input bytes they consumed. Returns
// false only on a malformed header within the consumed region.
bool split_blocks_partial(const uint8_t* data, size_t size,
                          std::vector<BgzfBlock>& blocks, size_t& consumed) {
  size_t pos = 0;
  while (pos + 18 <= size) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
    uint16_t xlen = static_cast<uint16_t>(data[pos + 10]) |
                    (static_cast<uint16_t>(data[pos + 11]) << 8);
    size_t extra = pos + 12;
    size_t extra_end = extra + xlen;
    if (extra_end + 8 > size) break;  // header spills past the slab
    uint32_t bsize = 0;
    size_t sub = extra;
    while (sub + 4 <= extra_end) {
      uint8_t si1 = data[sub], si2 = data[sub + 1];
      uint16_t slen = static_cast<uint16_t>(data[sub + 2]) |
                      (static_cast<uint16_t>(data[sub + 3]) << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        bsize = (static_cast<uint32_t>(data[sub + 4]) |
                 (static_cast<uint32_t>(data[sub + 5]) << 8)) + 1;
      }
      sub += 4 + slen;
    }
    if (bsize == 0) return false;
    if (pos + bsize > size) break;  // incomplete block payload
    size_t comp_begin = extra_end;
    size_t comp_end = pos + bsize - 8;  // crc32 + isize trailer
    BgzfBlock block;
    block.compressed.assign(data + comp_begin, data + comp_end);
    std::memcpy(&block.crc32_expect, data + comp_end, 4);
    std::memcpy(&block.isize, data + comp_end + 4, 4);
    blocks.push_back(std::move(block));
    pos += bsize;
  }
  consumed = pos;
  return true;
}

// ---------------------------------------------------------------------------
// Streaming BGZF reader: slab-at-a-time framing + parallel inflate with one
// slab of prefetch (the TPU-era counterpart of the reference's
// 1-reader -> 15-inflater -> ordered-readLine workflow,
// kel_io/kel_bzip_workflow.h:42 / kel_bzip_workflow.cpp). Bounded memory:
// one compressed slab + two decompressed slabs in flight, any file size.
// ---------------------------------------------------------------------------
struct BgzfSlab {
  std::vector<uint8_t> data;  // decompressed bytes
  bool ok = true;
  bool last = false;          // file exhausted after this slab
};

struct KgtBgzfStream {
  FILE* f = nullptr;
  int workers = 1;
  size_t slab_bytes = 24u << 20;
  bool verify = false;
  std::vector<uint8_t> carry;  // compressed tail (partial trailing block)
  BgzfSlab current;
  size_t pos = 0;              // consumed bytes of current.data
  bool have_pending = false;
  std::future<BgzfSlab> pending;
  bool error = false;
  bool done = false;

  BgzfSlab load_slab() {
    BgzfSlab res;
    size_t old = carry.size();
    carry.resize(old + slab_bytes);
    size_t got = std::fread(carry.data() + old, 1, slab_bytes, f);
    carry.resize(old + got);
    if (got < slab_bytes && std::ferror(f)) {
      // A transient read error can land on a block boundary and otherwise
      // masquerade as clean EOF, silently truncating the stream.
      res.ok = false;
      return res;
    }
    res.last = got < slab_bytes;
    std::vector<BgzfBlock> blocks;
    size_t consumed = 0;
    if (!split_blocks_partial(carry.data(), carry.size(), blocks, consumed) ||
        (res.last && consumed != carry.size())) {
      res.ok = false;  // malformed framing or trailing garbage at EOF
      return res;
    }
    std::vector<size_t> offsets(blocks.size() + 1, 0);
    for (size_t i = 0; i < blocks.size(); ++i)
      offsets[i + 1] = offsets[i] + blocks[i].isize;
    res.data.resize(offsets.back());
    std::atomic<size_t> next{0};
    std::atomic<bool> ok{true};
    bool check = verify;
    auto work = [&] {
      size_t i;
      while ((i = next.fetch_add(1)) < blocks.size()) {
        uint8_t* dst = res.data.data() + offsets[i];
        if (!inflate_block(blocks[i], dst)) {
          ok.store(false);
          continue;
        }
        if (check && blocks[i].isize) {
          uint32_t crc = static_cast<uint32_t>(
              ::crc32(0L, dst, blocks[i].isize));
          if (crc != blocks[i].crc32_expect) ok.store(false);
        }
      }
    };
    int n = std::max(1, workers);
    std::vector<std::thread> pool;
    for (int t = 1; t < n; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    res.ok = ok.load();
    carry.erase(carry.begin(), carry.begin() + consumed);
    return res;
  }

  void prefetch() {
    if (!have_pending && !done) {
      pending = std::async(std::launch::async, [this] { return load_slab(); });
      have_pending = true;
    }
  }

  // Fill out[0..cap); returns bytes written, 0 at EOF, -1 on error.
  long long read(char* out, long long cap) {
    if (error) return -1;
    long long written = 0;
    while (written < cap) {
      if (pos < current.data.size()) {
        size_t take = std::min<size_t>(current.data.size() - pos,
                                       static_cast<size_t>(cap - written));
        std::memcpy(out + written, current.data.data() + pos, take);
        pos += take;
        written += static_cast<long long>(take);
        continue;
      }
      if (done) break;
      if (current.last) {
        done = true;
        break;
      }
      if (!have_pending) prefetch();
      current = pending.get();
      have_pending = false;
      pos = 0;
      if (!current.ok) {
        error = true;
        return -1;
      }
      if (!current.last) prefetch();  // keep one slab in flight
    }
    return written;
  }
};

}  // namespace

extern "C" {

void* kgt_bgzf_open(const char* path, int n_threads, long long slab_bytes,
                    int verify) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new KgtBgzfStream();
  s->f = f;
  s->workers = n_threads > 0
                   ? n_threads
                   : std::max(1u, std::thread::hardware_concurrency());
  if (slab_bytes > 0) s->slab_bytes = static_cast<size_t>(slab_bytes);
  s->verify = verify != 0;
  s->prefetch();
  return s;
}

long long kgt_bgzf_read(void* handle, char* out, long long cap) {
  if (!handle) return -1;
  return static_cast<KgtBgzfStream*>(handle)->read(out, cap);
}

void kgt_bgzf_close(void* handle) {
  if (!handle) return;
  auto* s = static_cast<KgtBgzfStream*>(handle);
  if (s->have_pending) s->pending.wait();
  std::fclose(s->f);
  delete s;
}

// Decompress a whole BGZF file with parallel block inflate.
// Returns a malloc'd buffer (caller frees with kgt_free); *out_size is the
// uncompressed length. Returns nullptr on error.
char* kgt_bgzf_decompress(const char* path, int n_threads, size_t* out_size) {
  *out_size = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(static_cast<size_t>(fsize));
  if (fsize > 0 && std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<BgzfBlock> blocks;
  if (!split_blocks(raw.data(), raw.size(), blocks)) return nullptr;

  // Prefix offsets of each block in the output.
  std::vector<size_t> offsets(blocks.size() + 1, 0);
  for (size_t i = 0; i < blocks.size(); ++i)
    offsets[i + 1] = offsets[i] + blocks[i].isize;
  size_t total = offsets.back();
  char* out = static_cast<char*>(std::malloc(total ? total : 1));
  if (!out) return nullptr;

  std::atomic<size_t> next{0};
  std::atomic<bool> ok{true};
  int workers = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      size_t i;
      while ((i = next.fetch_add(1)) < blocks.size()) {
        if (!inflate_block(blocks[i],
                           reinterpret_cast<uint8_t*>(out) + offsets[i]))
          ok.store(false);
      }
    });
  }
  for (auto& th : pool) th.join();
  if (!ok.load()) {
    std::free(out);
    return nullptr;
  }
  *out_size = total;
  return out;
}

void kgt_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// VCF genotype-column tokenizer.
//
// Parse the genotype columns of ONE data line (the text AFTER the 9 fixed
// fields) into flat arrays:
//   gt_a, gt_b        (int32[n_samples])  allele indices; -1 = missing
//   ad                (int32[n_samples * (n_alleles + 1)]) allele depths
//   dp                (int32[n_samples])
//   gq                (float[n_samples])
// Index positions of GT/AD/DP/GQ within the FORMAT string are passed in
// (-1 = absent). Returns the number of samples parsed.
// ---------------------------------------------------------------------------
int kgt_vcf_parse_genotypes(const char* text, long len, int n_samples,
                            int n_alleles, int gt_idx, int ad_idx, int dp_idx,
                            int gq_idx, int32_t* gt_a, int32_t* gt_b,
                            int32_t* ad, int32_t* dp, float* gq,
                            int32_t* ad_count) {
  const char* p = text;
  const char* end = text + len;
  int sample = 0;
  int ad_width = n_alleles + 1;

  while (p < end && sample < n_samples) {
    // defaults
    gt_a[sample] = -1;
    gt_b[sample] = -1;
    dp[sample] = 0;
    gq[sample] = 0.0f;
    ad_count[sample] = 0;
    for (int a = 0; a < ad_width; ++a) ad[sample * ad_width + a] = 0;

    // scan one tab-delimited genotype column, splitting on ':'
    int field = 0;
    const char* fstart = p;
    while (true) {
      bool at_end = (p >= end) || (*p == '\t') || (*p == '\n');
      if (at_end || *p == ':') {
        long flen = p - fstart;
        if (field == gt_idx && flen > 0) {
          // diploid 'a[/|]b' only — any other GT shape leaves -1/-1 so the
          // sample is skipped (parity with io/vcf.py::_parse_gt + the
          // PfDiploidParser's len==2 requirement).
          int64_t parts[kMaxGtParts];
          bool phased = false;
          if (parse_gt_parts(fstart, fstart + flen, parts, phased) == 2) {
            gt_a[sample] = static_cast<int32_t>(parts[0]);
            gt_b[sample] = static_cast<int32_t>(parts[1]);
          }
        } else if (field == ad_idx && flen > 0 && *fstart != '.') {
          const char* q = fstart;
          int slot = 0;
          long v = 0;
          bool have = false;
          while (q <= fstart + flen) {
            if (q == fstart + flen || *q == ',') {
              if (have && slot < ad_width) ad[sample * ad_width + slot] = static_cast<int32_t>(v);
              ++slot;
              v = 0;
              have = false;
              if (q == fstart + flen) break;
            } else if (*q >= '0' && *q <= '9') {
              v = v * 10 + (*q - '0');
              have = true;
            }
            ++q;
          }
          ad_count[sample] = slot;
        } else if (field == dp_idx && flen > 0 && *fstart != '.') {
          long v = 0;
          for (const char* q = fstart; q < fstart + flen; ++q)
            if (*q >= '0' && *q <= '9') v = v * 10 + (*q - '0');
          dp[sample] = static_cast<int32_t>(v);
        } else if (field == gq_idx && flen > 0 && *fstart != '.') {
          gq[sample] = std::strtof(fstart, nullptr);
        }
        ++field;
        if (at_end) break;
        fstart = p + 1;
      }
      ++p;
    }
    ++sample;
    if (p < end && (*p == '\t')) ++p;
    if (p < end && *p == '\n') break;
  }
  return sample;
}

// Count '\n' characters (line counting for chunked readers).
long kgt_count_lines(const char* text, long len) {
  long count = 0;
  for (long i = 0; i < len; ++i)
    if (text[i] == '\n') ++count;
  return count;
}

// ---------------------------------------------------------------------------
// End-to-end VCF record-loop parser.
//
// The reference runs the record loop on 50 native consumer threads
// (kgl_parser/kgl_variant_factory_readvcf_impl.h:45,
//  kgl_variant_factory_pf_impl.cpp:56-380); this is the equivalent: the
// entire body of a VCF (every data line after the header) is tokenised in
// C++ and lands as flat columnar arrays — records never touch Python.
// Strings (contig/id/ref/alt/info) are returned as [start,end) offsets into
// the caller's text buffer (zero copy).
//
// Modes: 0 = Pf diploid GT+AD+DP+GQ incidences (unphased, hom alt emits TWO
//            incidences, '*'/zero-depth skipped, AD width must be
//            n_alleles+1);
//        1 = phased diploid (1000G): GT only, a|b -> phase A/B incidences;
//        2 = mono-genome (gnomAD): fixed fields + INFO only, no genotypes.
// ---------------------------------------------------------------------------

struct KgtVcfResult {
  int64_t n_records;
  int64_t n_alts;
  int64_t n_incidences;
  int64_t n_contigs;
  int64_t n_numeric;
  int64_t n_flags;
  int64_t ad_mismatch;
  int64_t bad_records;
  // per-record columns [n_records]
  int32_t* rec_contig;
  int64_t* rec_pos;   // 0-based offset (VCF POS - 1)
  float* rec_qual;
  uint8_t* rec_pass;
  int64_t* rec_id_start;
  int64_t* rec_id_end;
  int64_t* rec_ref_start;
  int64_t* rec_ref_end;
  int64_t* rec_info_start;
  int64_t* rec_info_end;
  int64_t* alt_row_start;  // [n_records + 1] CSR into alt arrays
  // per-alt [n_alts]
  int64_t* alt_start;
  int64_t* alt_end;
  // contig name table [n_contigs]
  int64_t* contig_start;
  int64_t* contig_end;
  // per-incidence [n_incidences]
  int32_t* inc_record;
  int32_t* inc_sample;
  int32_t* inc_allele;   // 1-based alt allele number
  uint8_t* inc_phase;    // 255 unphased, 1 phase A, 2 phase B
  int32_t* inc_ref_count;
  int32_t* inc_alt_count;
  int32_t* inc_dp;
  float* inc_gq;
  // subscribed INFO scalar columns, field-major [n_numeric/_flags][n_records]
  double* info_numeric;
  uint8_t* info_flags;
  // subscribed numeric-ARRAY INFO fields (Number=A/R/G/., Type Int/Float):
  // CSR per field. arr_field_start[f]..[f+1] bounds field f's segment of
  // arr_values; arr_offsets[f*(R+1) + r] is record r's start WITHIN the
  // segment; arr_present[f*R + r] = 0 when the field is absent.
  int64_t n_arrays;
  double* arr_values;
  int64_t* arr_field_start;   // [n_arrays + 1]
  int64_t* arr_offsets;       // [n_arrays * (R + 1)]
  uint8_t* arr_present;       // [n_arrays * R]
  // subscribed STRING INFO fields (everything else): value byte pools.
  int64_t n_strings;
  char* str_pool;
  int64_t* str_field_start;   // [n_strings + 1]
  int64_t* str_offsets;       // [n_strings * (R + 1)]
  uint8_t* str_present;       // [n_strings * R]
};

}  // extern "C"

namespace {

struct StrRange {
  int64_t start = 0;
  int64_t end = 0;
};

struct RecordRow {
  StrRange contig, id, ref, info;
  int64_t pos = 0;
  float qual = 0.0f;
  uint8_t pass = 1;
  int32_t n_alts = 0;
};

struct ThreadOut {
  std::vector<RecordRow> records;
  std::vector<StrRange> alts;
  std::vector<int32_t> inc_record;  // record index LOCAL to this thread
  std::vector<int32_t> inc_sample;
  std::vector<int32_t> inc_allele;
  std::vector<uint8_t> inc_phase;
  std::vector<int32_t> inc_ref_count;
  std::vector<int32_t> inc_alt_count;
  std::vector<int32_t> inc_dp;
  std::vector<float> inc_gq;
  std::vector<std::vector<double>> numeric;  // per subscribed numeric field
  std::vector<std::vector<uint8_t>> flags;
  // numeric-array fields: flat values + per-record element counts (-1 absent)
  std::vector<std::vector<double>> arr_values;
  std::vector<std::vector<int32_t>> arr_counts;
  // string fields: value byte pool + per-record lengths (-1 absent)
  std::vector<std::string> str_pool;
  std::vector<std::vector<int32_t>> str_lens;
  int64_t ad_mismatch = 0;
  int64_t bad_records = 0;
};

inline bool span_eq(const char* text, const StrRange& r, const char* lit) {
  int64_t n = r.end - r.start;
  return static_cast<int64_t>(std::strlen(lit)) == n &&
         std::memcmp(text + r.start, lit, n) == 0;
}

// Parse a non-negative integer; returns -1 on any non-digit.
inline int64_t parse_uint(const char* p, const char* end) {
  if (p >= end) return -1;
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') return -1;
    v = v * 10 + (*p - '0');
  }
  return v;
}

// Split subscribed field-name list ('\n'-joined) into string views.
std::vector<std::string> split_names(const char* joined) {
  std::vector<std::string> out;
  if (!joined || !*joined) return out;
  const char* p = joined;
  const char* start = p;
  for (;; ++p) {
    if (*p == '\n' || *p == '\0') {
      if (p > start) out.emplace_back(start, p - start);
      if (*p == '\0') break;
      start = p + 1;
    }
  }
  return out;
}

// Parse one data line into thread-local output. Returns false on a
// malformed line (counted, skipped) — mirrors _parse_record_line's
// warn-and-skip (io/vcf.py).
bool parse_line(const char* text, int64_t line_start, int64_t line_end,
                int n_samples, int mode,
                const std::vector<std::string>& numeric_names,
                const std::vector<std::string>& flag_names,
                const std::vector<std::string>& array_names,
                const std::vector<std::string>& string_names, ThreadOut& out) {
  // split fixed fields
  StrRange fields[9];
  int n_fields = 0;
  int64_t pos = line_start;
  int64_t fstart = line_start;
  while (pos <= line_end && n_fields < 9) {
    if (pos == line_end || text[pos] == '\t') {
      fields[n_fields].start = fstart;
      fields[n_fields].end = pos;
      ++n_fields;
      fstart = pos + 1;
      if (pos == line_end) break;
    }
    ++pos;
  }
  if (n_fields < 8) return false;
  int64_t vcf_pos =
      parse_uint(text + fields[1].start, text + fields[1].end);
  if (vcf_pos < 0) return false;

  RecordRow rec;
  rec.contig = fields[0];
  rec.pos = vcf_pos - 1;
  rec.id = fields[2];
  if (span_eq(text, rec.id, ".")) rec.id.end = rec.id.start;
  rec.ref = fields[3];
  rec.info = fields[7];
  // QUAL: '.'/'' -> 0; strtof stops at non-numeric -> Python float() would
  // raise; require full consumption else 0 (ValueError -> 0.0 parity).
  {
    const StrRange& q = fields[5];
    if (q.end > q.start && !span_eq(text, q, ".")) {
      char buf[64];
      int64_t n = q.end - q.start;
      if (n < 63) {
        std::memcpy(buf, text + q.start, n);
        buf[n] = '\0';
        char* endp = nullptr;
        float v = std::strtof(buf, &endp);
        if (endp == buf + n) rec.qual = v;
      }
    }
  }
  {
    const StrRange& f = fields[6];
    rec.pass = (f.end == f.start || span_eq(text, f, "PASS") ||
                span_eq(text, f, "."))
                   ? 1
                   : 0;
  }
  // ALT comma split
  int64_t alt_first = static_cast<int64_t>(out.alts.size());
  {
    int64_t astart = fields[4].start;
    for (int64_t i = fields[4].start; i <= fields[4].end; ++i) {
      if (i == fields[4].end || text[i] == ',') {
        out.alts.push_back({astart, i});
        ++rec.n_alts;
        astart = i + 1;
      }
    }
  }
  int n_alleles = rec.n_alts;

  // INFO subscribed fields (scalars, flags, numeric arrays, strings)
  if (!numeric_names.empty() || !flag_names.empty() || !array_names.empty() ||
      !string_names.empty()) {
    size_t nn = numeric_names.size(), nf = flag_names.size();
    size_t na = array_names.size(), ns = string_names.size();
    std::vector<double> num_vals(nn,
                                 std::numeric_limits<double>::quiet_NaN());
    std::vector<uint8_t> flag_vals(nf, 0);
    // per-record value spans for array/string fields (-1 start = absent)
    std::vector<StrRange> arr_spans(na, {-1, -1});
    std::vector<StrRange> str_spans(ns, {-1, -1});
    int64_t istart = rec.info.start;
    bool is_missing = span_eq(text, rec.info, ".");
    if (!is_missing) {
      for (int64_t i = rec.info.start; i <= rec.info.end; ++i) {
        if (i == rec.info.end || text[i] == ';') {
          if (i > istart) {
            // key[=value]
            int64_t eq = istart;
            while (eq < i && text[eq] != '=') ++eq;
            int64_t klen = eq - istart;
            for (size_t f = 0; f < nf; ++f) {
              if (static_cast<int64_t>(flag_names[f].size()) == klen &&
                  std::memcmp(text + istart, flag_names[f].data(), klen) == 0)
                flag_vals[f] = 1;
            }
            for (size_t f = 0; f < nn; ++f) {
              if (static_cast<int64_t>(numeric_names[f].size()) == klen &&
                  std::memcmp(text + istart, numeric_names[f].data(), klen) ==
                      0 &&
                  eq < i) {
                int64_t vstart = eq + 1, vend = i;
                int64_t n = vend - vstart;
                if (n > 0 && !(n == 1 && text[vstart] == '.')) {
                  char buf[64];
                  char* endp = nullptr;
                  if (n < 63) {
                    std::memcpy(buf, text + vstart, n);
                    buf[n] = '\0';
                    double v = std::strtod(buf, &endp);
                    if (endp == buf + n) num_vals[f] = v;
                  } else {
                    // rare >=63-char tokens: bounded heap copy instead of
                    // silently dropping the value (NaN)
                    std::string tmp(text + vstart, n);
                    double v = std::strtod(tmp.c_str(), &endp);
                    if (endp == tmp.c_str() + n) num_vals[f] = v;
                  }
                }
              }
            }
            // value span for array/string subscriptions; a bare key with
            // no '=' yields the empty span at eq==i (present, empty).
            int64_t vstart = (eq < i) ? eq + 1 : i;
            for (size_t f = 0; f < na; ++f) {
              if (static_cast<int64_t>(array_names[f].size()) == klen &&
                  std::memcmp(text + istart, array_names[f].data(), klen) == 0)
                arr_spans[f] = {vstart, i};
            }
            for (size_t f = 0; f < ns; ++f) {
              if (static_cast<int64_t>(string_names[f].size()) == klen &&
                  std::memcmp(text + istart, string_names[f].data(), klen) == 0)
                str_spans[f] = {vstart, i};
            }
          }
          istart = i + 1;
        }
      }
    }
    for (size_t f = 0; f < nn; ++f) out.numeric[f].push_back(num_vals[f]);
    for (size_t f = 0; f < nf; ++f) out.flags[f].push_back(flag_vals[f]);
    for (size_t f = 0; f < na; ++f) {
      const StrRange& sp = arr_spans[f];
      if (sp.start < 0) {
        out.arr_counts[f].push_back(-1);
        continue;
      }
      // comma-split doubles; empty/'.' elements land as NaN (None upstream)
      int32_t count = 0;
      int64_t tstart = sp.start;
      for (int64_t q = sp.start; q <= sp.end; ++q) {
        if (q == sp.end || text[q] == ',') {
          int64_t n = q - tstart;
          double v = std::numeric_limits<double>::quiet_NaN();
          if (n > 0 && !(n == 1 && text[tstart] == '.')) {
            char buf[64];
            char* endp = nullptr;
            if (n < 63) {
              std::memcpy(buf, text + tstart, n);
              buf[n] = '\0';
              double parsed = std::strtod(buf, &endp);
              if (endp == buf + n) v = parsed;
            } else {
              // rare >=63-char tokens: bounded heap copy, never NaN-drop.
              // (Integer arrays still round-trip through double: values
              // past 2^53 lose precision — acceptable for VCF INFO.)
              std::string tmp(text + tstart, n);
              double parsed = std::strtod(tmp.c_str(), &endp);
              if (endp == tmp.c_str() + n) v = parsed;
            }
          }
          out.arr_values[f].push_back(v);
          ++count;
          tstart = q + 1;
        }
      }
      out.arr_counts[f].push_back(count);
    }
    for (size_t f = 0; f < ns; ++f) {
      const StrRange& sp = str_spans[f];
      if (sp.start < 0) {
        out.str_lens[f].push_back(-1);
      } else {
        out.str_pool[f].append(text + sp.start, sp.end - sp.start);
        out.str_lens[f].push_back(static_cast<int32_t>(sp.end - sp.start));
      }
    }
  }

  int32_t local_rec = static_cast<int32_t>(out.records.size());
  out.records.push_back(rec);

  if (mode == 2 || n_samples == 0) return true;

  // FORMAT indices
  int gt_idx = -1, ad_idx = -1, dp_idx = -1, gq_idx = -1;
  if (n_fields >= 9) {
    int idx = 0;
    int64_t s = fields[8].start;
    for (int64_t i = fields[8].start; i <= fields[8].end; ++i) {
      if (i == fields[8].end || text[i] == ':') {
        int64_t n = i - s;
        if (n == 2 && text[s] == 'G' && text[s + 1] == 'T') gt_idx = idx;
        else if (n == 2 && text[s] == 'A' && text[s + 1] == 'D') ad_idx = idx;
        else if (n == 2 && text[s] == 'D' && text[s + 1] == 'P') dp_idx = idx;
        else if (n == 2 && text[s] == 'G' && text[s + 1] == 'Q') gq_idx = idx;
        ++idx;
        s = i + 1;
      }
    }
  }
  if (gt_idx < 0) return true;                 // record kept, no genotypes
  if (mode == 0 && ad_idx < 0) return true;    // Pf requires AD

  // genotype columns start after the 9th tab
  int64_t gpos = fields[8].end + 1;
  if (gpos > line_end) return true;

  int ad_width = n_alleles + 1;
  std::vector<int32_t> ad(ad_width);
  const char* t = text;
  int64_t p = gpos;
  for (int sample = 0; sample < n_samples && p <= line_end; ++sample) {
    // one tab-delimited genotype column, ':'-split fields
    int64_t gt_parts[kMaxGtParts];
    int n_gt = -1;
    bool phased = false;
    int32_t dp = 0;
    float gq = 0.0f;
    int ad_slots = 0;
    std::fill(ad.begin(), ad.end(), 0);
    int field = 0;
    int64_t fs = p;
    while (true) {
      bool at_end = (p >= line_end) || (t[p] == '\t');
      if (at_end || t[p] == ':') {
        int64_t flen = p - fs;
        if (field == gt_idx) {
          n_gt = parse_gt_parts(t + fs, t + p, gt_parts, phased);
        } else if (field == ad_idx && flen > 0 && t[fs] != '.') {
          int slot = 0;
          int64_t v = 0;
          bool have = false;
          for (int64_t q = fs; q <= p; ++q) {
            if (q == p || t[q] == ',') {
              if (have && slot < ad_width) ad[slot] = static_cast<int32_t>(v);
              ++slot;
              v = 0;
              have = false;
              if (q == p) break;
            } else if (t[q] >= '0' && t[q] <= '9') {
              v = v * 10 + (t[q] - '0');
              have = true;
            }
          }
          ad_slots = slot;
        } else if (field == dp_idx && flen > 0 && t[fs] != '.') {
          int64_t v = 0;
          for (int64_t q = fs; q < p; ++q)
            if (t[q] >= '0' && t[q] <= '9') v = v * 10 + (t[q] - '0');
          dp = static_cast<int32_t>(v);
        } else if (field == gq_idx && flen > 0 && t[fs] != '.') {
          char buf[64];
          int64_t n = p - fs;
          if (n < 63) {
            std::memcpy(buf, t + fs, n);
            buf[n] = '\0';
            gq = std::strtof(buf, nullptr);
          }
        }
        ++field;
        if (at_end) break;
        fs = p + 1;
      }
      ++p;
    }

    if (mode == 0) {
      // Pf diploid: GT must be diploid (len != 2 skips the sample, parity
      // with PfDiploidParser); both alleles contribute; hom 1/1 emits TWO
      // incidences (kgl_variant_factory_pf_impl.cpp:287,336).
      if (n_gt == 2 && (gt_parts[0] > 0 || gt_parts[1] > 0)) {
        if (ad_slots != ad_width) {
          ++out.ad_mismatch;
        } else {
          for (int k = 0; k < 2; ++k) {
            int64_t allele = gt_parts[k];
            if (allele <= 0 || allele > n_alleles) continue;
            const StrRange& alt = out.alts[alt_first + allele - 1];
            if (alt.end - alt.start == 1 &&
                (t[alt.start] == '*' || t[alt.start] == '.'))
              continue;  // upstream-deletion / missing allele
            if (alt.end == alt.start) continue;
            int32_t rc = ad[0];
            int32_t ac = ad[allele];
            if (rc == 0 && ac == 0) continue;  // spanning downstream deletion
            out.inc_record.push_back(local_rec);
            out.inc_sample.push_back(sample);
            out.inc_allele.push_back(static_cast<int32_t>(allele));
            out.inc_phase.push_back(255);
            out.inc_ref_count.push_back(rc);
            out.inc_alt_count.push_back(ac);
            out.inc_dp.push_back(dp);
            out.inc_gq.push_back(gq);
          }
        }
      }
    } else if (n_gt > 0) {
      // phased diploid (1000G): a|b -> phase A / phase B; unphased or
      // non-diploid GT falls back to UNPHASED incidences
      // (kgl_variant_factory_1000_impl.cpp:93-127).
      bool assign_phase = phased && n_gt == 2;
      for (int k = 0; k < n_gt; ++k) {
        int64_t allele = gt_parts[k];
        if (allele <= 0 || allele > n_alleles) continue;
        const StrRange& alt = out.alts[alt_first + allele - 1];
        if (alt.end - alt.start == 1 && t[alt.start] == '*') continue;
        uint8_t phase = assign_phase ? static_cast<uint8_t>(k + 1) : 255;
        out.inc_record.push_back(local_rec);
        out.inc_sample.push_back(sample);
        out.inc_allele.push_back(static_cast<int32_t>(allele));
        out.inc_phase.push_back(phase);
        out.inc_ref_count.push_back(0);
        out.inc_alt_count.push_back(0);
        out.inc_dp.push_back(0);
        out.inc_gq.push_back(0.0f);
      }
    }
    if (p < line_end && t[p] == '\t') ++p;
  }
  return true;
}

template <typename T>
T* alloc_col(int64_t n) {
  return static_cast<T*>(std::malloc(sizeof(T) * (n > 0 ? n : 1)));
}

}  // namespace

extern "C" {

KgtVcfResult* kgt_vcf_parse_records(const char* text, int64_t len,
                                    int64_t body_start, int n_samples,
                                    int mode, const char* numeric_joined,
                                    const char* flag_joined,
                                    const char* array_joined,
                                    const char* string_joined, int n_threads) {
  auto numeric_names = split_names(numeric_joined);
  auto flag_names = split_names(flag_joined);
  auto array_names = split_names(array_joined);
  auto string_names = split_names(string_joined);

  // line index (single pass; memchr is memory-bound)
  std::vector<int64_t> line_starts;
  {
    int64_t pos = body_start;
    while (pos < len) {
      line_starts.push_back(pos);
      const char* nl = static_cast<const char*>(
          std::memchr(text + pos, '\n', static_cast<size_t>(len - pos)));
      if (!nl) break;
      pos = (nl - text) + 1;
    }
  }
  int64_t n_lines = static_cast<int64_t>(line_starts.size());
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n_lines && n_lines > 0) workers = static_cast<int>(n_lines);
  if (workers < 1) workers = 1;

  std::vector<ThreadOut> outs(workers);
  for (auto& o : outs) {
    o.numeric.resize(numeric_names.size());
    o.flags.resize(flag_names.size());
    o.arr_values.resize(array_names.size());
    o.arr_counts.resize(array_names.size());
    o.str_pool.resize(string_names.size());
    o.str_lens.resize(string_names.size());
  }
  auto run = [&](int w) {
    ThreadOut& out = outs[w];
    int64_t lo = n_lines * w / workers;
    int64_t hi = n_lines * (w + 1) / workers;
    for (int64_t li = lo; li < hi; ++li) {
      int64_t start = line_starts[li];
      int64_t end = (li + 1 < n_lines) ? line_starts[li + 1] - 1 : len;
      while (end > start && (text[end - 1] == '\n' || text[end - 1] == '\r'))
        --end;
      if (end <= start) continue;
      if (text[start] == '#') continue;  // stray header line
      if (!parse_line(text, start, end, n_samples, mode, numeric_names,
                      flag_names, array_names, string_names, out))
        ++out.bad_records;
    }
  };
  if (workers == 1) {
    run(0);
  } else {
    std::vector<std::thread> pool;
    for (int w = 0; w < workers; ++w) pool.emplace_back(run, w);
    for (auto& th : pool) th.join();
  }

  // merge
  int64_t R = 0, A = 0, I = 0;
  for (auto& o : outs) {
    R += static_cast<int64_t>(o.records.size());
    A += static_cast<int64_t>(o.alts.size());
    I += static_cast<int64_t>(o.inc_record.size());
  }
  auto* res = static_cast<KgtVcfResult*>(std::calloc(1, sizeof(KgtVcfResult)));
  if (!res) return nullptr;
  res->n_records = R;
  res->n_alts = A;
  res->n_incidences = I;
  res->n_numeric = static_cast<int64_t>(numeric_names.size());
  res->n_flags = static_cast<int64_t>(flag_names.size());
  res->rec_contig = alloc_col<int32_t>(R);
  res->rec_pos = alloc_col<int64_t>(R);
  res->rec_qual = alloc_col<float>(R);
  res->rec_pass = alloc_col<uint8_t>(R);
  res->rec_id_start = alloc_col<int64_t>(R);
  res->rec_id_end = alloc_col<int64_t>(R);
  res->rec_ref_start = alloc_col<int64_t>(R);
  res->rec_ref_end = alloc_col<int64_t>(R);
  res->rec_info_start = alloc_col<int64_t>(R);
  res->rec_info_end = alloc_col<int64_t>(R);
  res->alt_row_start = alloc_col<int64_t>(R + 1);
  res->alt_start = alloc_col<int64_t>(A);
  res->alt_end = alloc_col<int64_t>(A);
  res->inc_record = alloc_col<int32_t>(I);
  res->inc_sample = alloc_col<int32_t>(I);
  res->inc_allele = alloc_col<int32_t>(I);
  res->inc_phase = alloc_col<uint8_t>(I);
  res->inc_ref_count = alloc_col<int32_t>(I);
  res->inc_alt_count = alloc_col<int32_t>(I);
  res->inc_dp = alloc_col<int32_t>(I);
  res->inc_gq = alloc_col<float>(I);
  res->info_numeric = alloc_col<double>(res->n_numeric * R);
  res->info_flags = alloc_col<uint8_t>(res->n_flags * R);
  res->n_arrays = static_cast<int64_t>(array_names.size());
  res->n_strings = static_cast<int64_t>(string_names.size());
  {
    int64_t na = res->n_arrays, ns = res->n_strings;
    int64_t total_vals = 0, total_pool = 0;
    for (auto& o : outs) {
      for (auto& v : o.arr_values) total_vals += static_cast<int64_t>(v.size());
      for (auto& s : o.str_pool) total_pool += static_cast<int64_t>(s.size());
    }
    res->arr_values = alloc_col<double>(total_vals);
    res->arr_field_start = alloc_col<int64_t>(na + 1);
    res->arr_offsets = alloc_col<int64_t>(na * (R + 1));
    res->arr_present = alloc_col<uint8_t>(na * R);
    res->str_pool = alloc_col<char>(total_pool);
    res->str_field_start = alloc_col<int64_t>(ns + 1);
    res->str_offsets = alloc_col<int64_t>(ns * (R + 1));
    res->str_present = alloc_col<uint8_t>(ns * R);
    // field-major merge: for each field, walk the thread outputs in order
    int64_t vcur = 0;
    res->arr_field_start[0] = 0;
    for (int64_t f = 0; f < na; ++f) {
      int64_t* offs = res->arr_offsets + f * (R + 1);
      uint8_t* pres = res->arr_present + f * R;
      int64_t rec = 0, seg = 0;
      for (auto& o : outs) {
        const auto& vals = o.arr_values[f];
        std::memcpy(res->arr_values + vcur + seg, vals.data(),
                    vals.size() * sizeof(double));
        for (int32_t c : o.arr_counts[f]) {
          offs[rec] = seg;
          pres[rec] = c >= 0;
          if (c > 0) seg += c;
          ++rec;
        }
      }
      offs[R] = seg;
      vcur += seg;
      res->arr_field_start[f + 1] = vcur;
    }
    int64_t pcur = 0;
    res->str_field_start[0] = 0;
    for (int64_t f = 0; f < ns; ++f) {
      int64_t* offs = res->str_offsets + f * (R + 1);
      uint8_t* pres = res->str_present + f * R;
      int64_t rec = 0, seg = 0;
      for (auto& o : outs) {
        const auto& pool = o.str_pool[f];
        std::memcpy(res->str_pool + pcur + seg, pool.data(), pool.size());
        for (int32_t l : o.str_lens[f]) {
          offs[rec] = seg;
          pres[rec] = l >= 0;
          if (l > 0) seg += l;
          ++rec;
        }
      }
      offs[R] = seg;
      pcur += seg;
      res->str_field_start[f + 1] = pcur;
    }
  }

  // contig interning: VCFs are contig-grouped, so memoise the last name.
  std::vector<StrRange> contig_table;
  int32_t last_contig = -1;
  StrRange last_range{-1, -1};
  auto intern_contig = [&](const StrRange& r) -> int32_t {
    if (last_contig >= 0 && (r.end - r.start) == (last_range.end - last_range.start) &&
        std::memcmp(text + r.start, text + last_range.start,
                    r.end - r.start) == 0)
      return last_contig;
    for (size_t c = 0; c < contig_table.size(); ++c) {
      const StrRange& e = contig_table[c];
      if ((r.end - r.start) == (e.end - e.start) &&
          std::memcmp(text + r.start, text + e.start, r.end - r.start) == 0) {
        last_contig = static_cast<int32_t>(c);
        last_range = e;
        return last_contig;
      }
    }
    contig_table.push_back(r);
    last_contig = static_cast<int32_t>(contig_table.size() - 1);
    last_range = r;
    return last_contig;
  };

  int64_t r = 0, a = 0, i = 0;
  for (auto& o : outs) {
    int64_t rec_base = r;
    int64_t alt_base = a;
    for (size_t f = 0; f < numeric_names.size(); ++f)
      std::memcpy(res->info_numeric + f * R + rec_base, o.numeric[f].data(),
                  o.numeric[f].size() * sizeof(double));
    for (size_t f = 0; f < flag_names.size(); ++f)
      std::memcpy(res->info_flags + f * R + rec_base, o.flags[f].data(),
                  o.flags[f].size() * sizeof(uint8_t));
    int64_t alt_cursor = alt_base;
    for (const RecordRow& rec : o.records) {
      res->rec_contig[r] = intern_contig(rec.contig);
      res->rec_pos[r] = rec.pos;
      res->rec_qual[r] = rec.qual;
      res->rec_pass[r] = rec.pass;
      res->rec_id_start[r] = rec.id.start;
      res->rec_id_end[r] = rec.id.end;
      res->rec_ref_start[r] = rec.ref.start;
      res->rec_ref_end[r] = rec.ref.end;
      res->rec_info_start[r] = rec.info.start;
      res->rec_info_end[r] = rec.info.end;
      res->alt_row_start[r] = alt_cursor;
      alt_cursor += rec.n_alts;
      ++r;
    }
    for (const StrRange& alt : o.alts) {
      res->alt_start[a] = alt.start;
      res->alt_end[a] = alt.end;
      ++a;
    }
    for (size_t k = 0; k < o.inc_record.size(); ++k) {
      res->inc_record[i] =
          static_cast<int32_t>(rec_base + o.inc_record[k]);
      res->inc_sample[i] = o.inc_sample[k];
      res->inc_allele[i] = o.inc_allele[k];
      res->inc_phase[i] = o.inc_phase[k];
      res->inc_ref_count[i] = o.inc_ref_count[k];
      res->inc_alt_count[i] = o.inc_alt_count[k];
      res->inc_dp[i] = o.inc_dp[k];
      res->inc_gq[i] = o.inc_gq[k];
      ++i;
    }
    res->ad_mismatch += o.ad_mismatch;
    res->bad_records += o.bad_records;
  }
  res->alt_row_start[R] = A;
  res->n_contigs = static_cast<int64_t>(contig_table.size());
  res->contig_start = alloc_col<int64_t>(res->n_contigs);
  res->contig_end = alloc_col<int64_t>(res->n_contigs);
  for (int64_t c = 0; c < res->n_contigs; ++c) {
    res->contig_start[c] = contig_table[c].start;
    res->contig_end[c] = contig_table[c].end;
  }
  return res;
}

void kgt_vcf_result_free(KgtVcfResult* res) {
  if (!res) return;
  std::free(res->rec_contig);
  std::free(res->rec_pos);
  std::free(res->rec_qual);
  std::free(res->rec_pass);
  std::free(res->rec_id_start);
  std::free(res->rec_id_end);
  std::free(res->rec_ref_start);
  std::free(res->rec_ref_end);
  std::free(res->rec_info_start);
  std::free(res->rec_info_end);
  std::free(res->alt_row_start);
  std::free(res->alt_start);
  std::free(res->alt_end);
  std::free(res->contig_start);
  std::free(res->contig_end);
  std::free(res->inc_record);
  std::free(res->inc_sample);
  std::free(res->inc_allele);
  std::free(res->inc_phase);
  std::free(res->inc_ref_count);
  std::free(res->inc_alt_count);
  std::free(res->inc_dp);
  std::free(res->inc_gq);
  std::free(res->info_numeric);
  std::free(res->info_flags);
  std::free(res->arr_values);
  std::free(res->arr_field_start);
  std::free(res->arr_offsets);
  std::free(res->arr_present);
  std::free(res->str_pool);
  std::free(res->str_field_start);
  std::free(res->str_offsets);
  std::free(res->str_present);
  std::free(res);
}


// ---------------------------------------------------------------------------
// Indel-apply replay: byte-exact host reconstruction of the device indel
// forward step's mutated coding sequences (ops/pipeline.py _forward_indel
// steps 1-4). The pooled TPU program ships 8-byte tails over the remote
// link; the strings re-derive here from the same capture tensors — one
// sequential pass per genome, genomes fanned across threads (the numpy
// replay cost ~55 ms per 250-genome step on this 2-vCPU host; this loop
// runs it in ~1-2 ms). Reference semantics: AdjustedSequence +
// ModifiedOffsetMap (kgl_mutation/kgl_mutation_sequence.h:26).
// ---------------------------------------------------------------------------
extern "C" int kgt_indel_reconstruct(
    const uint8_t* region, int64_t L,
    const int64_t* exon_bounds, int n_exons,
    int reverse_strand,
    const int32_t* pos, const int8_t* kind, const int32_t* del_len,
    const uint8_t* ins_codes, const int32_t* ins_len, const uint8_t* alt,
    const uint8_t* valid, int64_t B, int64_t K, int64_t A,
    int64_t pad_coding, const uint8_t* complement,
    uint8_t* coding_out, int32_t* len_out, int64_t S_pad) {
  const int64_t W_out = L + pad_coding;
  int workers = std::max(1u, std::thread::hardware_concurrency());
  if (workers > B && B > 0) workers = static_cast<int>(B);
  if (workers < 1) workers = 1;

  auto run = [&](int w) {
    std::vector<int32_t> marker(L + 1), ins_at(L + 1), m_map(L + 1);
    std::vector<uint8_t> base(L), outbuf(W_out), rev(S_pad);
    int64_t lo_b = B * w / workers, hi_b = B * (w + 1) / workers;
    for (int64_t b = lo_b; b < hi_b; ++b) {
      std::fill(marker.begin(), marker.end(), 0);
      std::fill(ins_at.begin(), ins_at.end(), 0);
      std::memcpy(base.data(), region, L);
      std::fill(outbuf.begin(), outbuf.end(), 4);
      const int32_t* bp = pos + b * K;
      const int8_t* bk = kind + b * K;
      const int32_t* bd = del_len + b * K;
      const int32_t* bl = ins_len + b * K;
      const uint8_t* ba = alt + b * K;
      const uint8_t* bv = valid + b * K;
      for (int64_t k = 0; k < K; ++k) {
        if (!bv[k]) continue;
        int64_t p = bp[k];
        if (bk[k] == 0) {
          if (p >= 0 && p < L) base[p] = ba[k];
        } else if (bk[k] == 1) {
          if (p >= 0 && p <= L) {
            marker[p] += 1;
            int64_t e = std::min<int64_t>(p + bd[k], L);
            marker[e] -= 1;
          }
        } else if (bk[k] == 2) {
          if (p >= 0 && p <= L) ins_at[p] += bl[k];
        }
      }
      // exclusive prefix of unit = ins_at + keep; m_map = cum + ins_at
      int64_t cum = 0, run_del = 0;
      for (int64_t p = 0; p <= L; ++p) {
        int keep = 0;
        if (p < L) {
          run_del += marker[p];
          keep = run_del > 0 ? 0 : 1;
          if (keep) {
            int64_t dst = cum + ins_at[p];
            if (dst < W_out) outbuf[dst] = base[p];
          }
        }
        m_map[p] = static_cast<int32_t>(cum + ins_at[p]);
        cum += ins_at[p] + keep;
      }
      // inserted bases at cum_excl[pos] + j = m_map[pos] - ins_at[pos] + j
      for (int64_t k = 0; k < K; ++k) {
        if (!bv[k] || bk[k] != 2) continue;
        int64_t p = bp[k];
        if (p < 0 || p > L) continue;
        int64_t start = m_map[p] - ins_at[p];
        const uint8_t* codes = ins_codes + (b * K + k) * A;
        int64_t n = std::min<int64_t>(bl[k], A);
        for (int64_t j = 0; j < n; ++j) {
          int64_t dst = start + j;
          if (dst >= 0 && dst < W_out) outbuf[dst] = codes[j];
        }
      }
      // exon splice in modified coordinates
      uint8_t* out_row = coding_out + b * S_pad;
      std::memset(out_row, 4, S_pad);
      int64_t cs = 0;
      for (int e = 0; e < n_exons; ++e) {
        int64_t lo = exon_bounds[2 * e], hi = exon_bounds[2 * e + 1];
        int64_t mlo = m_map[lo], mhi = m_map[hi];
        int64_t le = mhi - mlo;
        for (int64_t c = 0; c < le && cs + c < S_pad; ++c) {
          int64_t src = mlo + c;
          if (src < 0) src = 0;
          if (src >= W_out) src = W_out - 1;
          out_row[cs + c] = outbuf[src];
        }
        cs += le;
      }
      len_out[b] = static_cast<int32_t>(cs);
      if (reverse_strand) {
        for (int64_t c = 0; c < S_pad; ++c) {
          if (c < cs) {
            int64_t src = cs - 1 - c;
            if (src < 0) src = 0;
            if (src >= S_pad) src = S_pad - 1;
            rev[c] = complement[out_row[src]];
          } else {
            rev[c] = 4;
          }
        }
        std::memcpy(out_row, rev.data(), S_pad);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(run, t);
  run(0);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// Variant-major CSR build: keys = rank(variant)*n_genomes + genome for every
// incidence, LSD radix sort, run-length dedup into (variant, genome,
// zygosity) triples. The threaded native form of the reference's
// transposed-view build (kgl_genomics/kgl_variant_db/
// kgl_variant_db_variant.h:26-83); the numpy radix-sort form of this build
// was 84% of the 1M x 1k scale stats phase (42.7 s) while the chip idled.
// ---------------------------------------------------------------------------
namespace {

template <typename K>
void radix_sort_keys(std::vector<K>& keys, int workers) {
  const int64_t n = static_cast<int64_t>(keys.size());
  if (n <= 1) return;
  std::vector<K> tmp(n);
  K* src = keys.data();
  K* dst = tmp.data();
  const int passes = static_cast<int>(sizeof(K));
  std::vector<int64_t> hist(static_cast<size_t>(workers) * 256);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * 8;
    // skip passes whose byte is constant (common for high bytes)
    std::fill(hist.begin(), hist.end(), 0);
    std::vector<std::thread> pool;
    auto count = [&](int w) {
      int64_t lo = n * w / workers, hi = n * (w + 1) / workers;
      int64_t* h = hist.data() + static_cast<size_t>(w) * 256;
      for (int64_t i = lo; i < hi; ++i)
        ++h[(src[i] >> shift) & 0xFF];
    };
    for (int t = 1; t < workers; ++t) pool.emplace_back(count, t);
    count(0);
    for (auto& th : pool) th.join();
    pool.clear();
    // exclusive prefix over (bucket, worker) in bucket-major order
    // A byte is constant when one bucket holds every key, summed over the
    // workers: one worker's count alone reaches n only with one worker.
    int64_t sum = 0;
    bool constant_byte = false;
    for (int b = 0; b < 256; ++b) {
      int64_t bucket = 0;
      for (int w = 0; w < workers; ++w) {
        int64_t& h = hist[static_cast<size_t>(w) * 256 + b];
        int64_t c = h;
        bucket += c;
        h = sum;
        sum += c;
      }
      if (bucket == n) constant_byte = true;
    }
    if (constant_byte) continue;  // nothing moves this pass
    auto scatter = [&](int w) {
      int64_t lo = n * w / workers, hi = n * (w + 1) / workers;
      int64_t* h = hist.data() + static_cast<size_t>(w) * 256;
      for (int64_t i = lo; i < hi; ++i)
        dst[h[(src[i] >> shift) & 0xFF]++] = src[i];
    };
    for (int t = 1; t < workers; ++t) pool.emplace_back(scatter, t);
    scatter(0);
    for (auto& th : pool) th.join();
    std::swap(src, dst);
  }
  if (src != keys.data())
    std::memcpy(keys.data(), src, static_cast<size_t>(n) * sizeof(K));
}

template <typename K>
int64_t csr_build_impl(const int32_t* const* part_rows,
                       const int64_t* part_lens, const int32_t* part_gidx,
                       int64_t n_parts, const int32_t* rank_of_row,
                       int64_t n_g, int64_t total, uint8_t* values_out,
                       int32_t* variant_out, int32_t* genome_out) {
  int workers = std::max(1u, std::thread::hardware_concurrency());
  std::vector<K> keys(total);
  // part offsets
  std::vector<int64_t> offs(n_parts + 1, 0);
  for (int64_t p = 0; p < n_parts; ++p) offs[p + 1] = offs[p] + part_lens[p];
  {
    std::atomic<int64_t> next{0};
    auto work = [&] {
      int64_t p;
      while ((p = next.fetch_add(1)) < n_parts) {
        const int32_t* rows = part_rows[p];
        const K g = static_cast<K>(part_gidx[p]);
        K* out = keys.data() + offs[p];
        const int64_t len = part_lens[p];
        for (int64_t i = 0; i < len; ++i)
          out[i] = static_cast<K>(rank_of_row[rows[i]]) *
                       static_cast<K>(n_g) + g;
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < workers; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
  }
  radix_sort_keys(keys, workers);
  // run-length dedup
  int64_t nnz = 0;
  int64_t i = 0;
  const K ng = static_cast<K>(n_g);
  while (i < total) {
    K k = keys[i];
    int64_t j = i + 1;
    while (j < total && keys[j] == k) ++j;
    values_out[nnz] = static_cast<uint8_t>(std::min<int64_t>(j - i, 2));
    variant_out[nnz] = static_cast<int32_t>(k / ng);
    genome_out[nnz] = static_cast<int32_t>(k % ng);
    ++nnz;
    i = j;
  }
  return nnz;
}

}  // namespace

extern "C" int64_t kgt_csr_build(
    const void* const* part_rows, const int64_t* part_lens,
    const int32_t* part_gidx, int64_t n_parts,
    const int32_t* rank_of_row, int64_t n_g, int64_t key_max,
    int64_t total, uint8_t* values_out, int32_t* variant_out,
    int32_t* genome_out) {
  auto rows = reinterpret_cast<const int32_t* const*>(part_rows);
  if (key_max < (int64_t(1) << 32))
    return csr_build_impl<uint32_t>(rows, part_lens, part_gidx, n_parts,
                                    rank_of_row, n_g, total, values_out,
                                    variant_out, genome_out);
  return csr_build_impl<uint64_t>(rows, part_lens, part_gidx, n_parts,
                                  rank_of_row, n_g, total, values_out,
                                  variant_out, genome_out);
}

extern "C" void kgt_mark_presence(
    const void* const* part_rows, const int64_t* part_lens, int64_t n_parts,
    uint8_t* present) {
  // Presence bitmap over arena rows (byte stores of 1 are idempotent, so
  // concurrent writers need no atomics).
  auto rows_pp = reinterpret_cast<const int32_t* const*>(part_rows);
  int workers = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next{0};
  auto work = [&] {
    int64_t p;
    while ((p = next.fetch_add(1)) < n_parts) {
      const int32_t* rows = rows_pp[p];
      const int64_t len = part_lens[p];
      for (int64_t i = 0; i < len; ++i) present[rows[i]] = 1;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}
