// Native FASTQ scanner — the host data-loader hot path.
//
// TPU-native equivalent of the reference's rust-bio FASTQ reader + worker
// threads pulling records off a mutex (reference: src/pseudoaligner.rs:
// 430-450, src/utils.rs:152-157 [dep]): here the parse feeds fixed-shape
// device batches, so the scanner writes base codes straight into the
// [B, L] batch buffer (A=0,C=1,G=2,T=3; other bytes -> 0, matching
// DnaString::from_dna_string's handling) and reports id/sequence spans so
// Python materializes names lazily.
//
// Input is a caller-provided buffer (Python mmaps the file, or feeds
// decompressed gzip chunks); records split across the buffer end are left
// for the next call via the returned resume offset.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

inline const char* find_nl(const char* p, const char* end) {
  const void* q = memchr(p, '\n', (size_t)(end - p));
  return q ? (const char*)q : nullptr;
}

// Python bytes.split(None) whitespace (within a line: no '\n')
inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

}  // namespace

extern "C" {

// Returns the number of parsed reads (>= 0), or -1 on malformed input.
// Outputs per read i:
//   lens[i]      — sequence length (bases)
//   id_off[2i]   — offset of the id (after '@', first token), id_off[2i+1] length
//   seq_off[i]   — offset of the sequence line in buf
//   codes[i*L..] — base codes for the first min(len, L) bases
// *resume_off    — buffer offset of the first unconsumed byte (start of the
//                  first incomplete record)
int64_t pa_fastq_scan(const char* buf, int64_t n, int64_t start,
                      int64_t max_reads, int32_t L, uint8_t* codes,
                      int32_t* lens, int64_t* id_off, int64_t* seq_off,
                      int64_t* resume_off, int32_t final_chunk) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 0, sizeof(lut));
    lut['A'] = 0; lut['C'] = 1; lut['G'] = 2; lut['T'] = 3;
    lut['a'] = 0; lut['c'] = 1; lut['g'] = 2; lut['t'] = 3;
    init = true;
  }
  const char* base = buf;
  const char* end = buf + n;
  const char* p = buf + start;
  int64_t count = 0;

  while (count < max_reads) {
    const char* rec_start = p;
    if (p >= end) break;
    if (*p != '@') return -1;
    const char* h_end = find_nl(p, end);
    if (!h_end) break;
    // id = first whitespace-delimited token after '@'.  Trim ALL
    // trailing CRs and treat \r/\v/\f as delimiters too — the Python
    // readers' header[1:].split(None, 1)[0] skips leading whitespace
    // and splits on any whitespace byte (multi-CR line endings
    // otherwise leave a '\r' inside the native id: review r5)
    const char* id_s = p + 1;
    const char* h_stop = h_end;
    while (h_stop > id_s && h_stop[-1] == '\r') h_stop--;
    while (id_s < h_stop && is_ws(*id_s)) id_s++;
    const char* id_e = id_s;
    while (id_e < h_stop && !is_ws(*id_e)) id_e++;

    const char* s = h_end + 1;
    const char* s_end = find_nl(s, end);
    if (!s_end) { p = rec_start; break; }
    const char* s_stop = s_end;
    while (s_stop > s && s_stop[-1] == '\r') s_stop--;

    const char* plus = s_end + 1;
    const char* plus_end = find_nl(plus, end);
    if (!plus_end) { p = rec_start; break; }
    if (plus >= end || *plus != '+') return -1;

    const char* q = plus_end + 1;
    const char* q_end = find_nl(q, end);
    if (!q_end) {
      // final record may lack a trailing newline: accept if the qual line
      // is complete (covers the seq at TRIMMED length — rust-bio reads
      // qual lines until qual.trim_end().len() >= seq.len(), so a CRLF
      // file truncated at 'III\r' for a 4-base seq is incomplete) at
      // buffer end — but ONLY when the caller says this buffer really is
      // the end of the stream (final_chunk): a streaming (gz) chunk
      // boundary could otherwise split a zero-length-sequence record
      // after its '+' line and the acceptance would consume it without
      // its qual line, desyncing the next scan
      int64_t qlen = end - q;
      while (qlen > 0 && q[qlen - 1] == '\r') qlen--;  // trim ALL: the
      // Python readers rstrip every trailing CR (rust-bio trim_end)
      if (final_chunk && qlen >= s_stop - s) q_end = end - 1;
      else { p = rec_start; break; }
    }

    int64_t slen = s_stop - s;
    lens[count] = (int32_t)slen;
    id_off[2 * count] = id_s - base;
    id_off[2 * count + 1] = id_e - id_s;
    seq_off[count] = s - base;
    int64_t ncopy = slen < L ? slen : L;
    uint8_t* dst = codes + count * (int64_t)L;
    for (int64_t i = 0; i < ncopy; i++) dst[i] = lut[(uint8_t)s[i]];
    if (ncopy < L) memset(dst + ncopy, 0, (size_t)(L - ncopy));
    count++;
    p = q_end + 1;
  }
  *resume_off = p - base;
  return count;
}

// R1 prefix scan (single-cell count path): copy the first P RAW sequence
// bytes per record (N and case PRESERVED — barcode/UMI semantics need
// the original bytes, unlike the code-emitting scan above) into
// out[count*P..].  Records whose sequence is shorter than P get a row of
// 0xFF (the too-short marker: 0xFF never occurs in FASTQ text).  Same
// structure validation + resume contract as pa_fastq_scan.
int64_t pa_fastq_scan_prefix(const char* buf, int64_t n, int64_t start,
                             int64_t max_reads, int32_t P, uint8_t* out,
                             int64_t* resume_off, int32_t final_chunk) {
  const char* base = buf;
  const char* end = buf + n;
  const char* p = buf + start;
  int64_t count = 0;

  while (count < max_reads) {
    const char* rec_start = p;
    if (p >= end) break;
    if (*p != '@') return -1;
    const char* h_end = find_nl(p, end);
    if (!h_end) break;

    const char* s = h_end + 1;
    const char* s_end = find_nl(s, end);
    if (!s_end) { p = rec_start; break; }
    const char* s_stop = s_end;  // trim ALL trailing CRs (review r5)
    while (s_stop > s && s_stop[-1] == '\r') s_stop--;

    const char* plus = s_end + 1;
    const char* plus_end = find_nl(plus, end);
    if (!plus_end) { p = rec_start; break; }
    if (plus >= end || *plus != '+') return -1;

    const char* q = plus_end + 1;
    const char* q_end = find_nl(q, end);
    if (!q_end) {
      // same final-chunk gate as pa_fastq_scan (zero-length-seq records
      // at a streaming chunk boundary; trimmed-length qual coverage)
      int64_t qlen = end - q;
      while (qlen > 0 && q[qlen - 1] == '\r') qlen--;  // trim ALL: the
      // Python readers rstrip every trailing CR (rust-bio trim_end)
      if (final_chunk && qlen >= s_stop - s) q_end = end - 1;
      else { p = rec_start; break; }
    }

    uint8_t* dst = out + count * (int64_t)P;
    if (s_stop - s < P) {
      memset(dst, 0xFF, (size_t)P);
    } else {
      memcpy(dst, s, (size_t)P);
    }
    count++;
    p = q_end + 1;
  }
  *resume_off = p - base;
  return count;
}

// Fused R1 key derivation for the single-cell count path
// (singlecell.py::consume): ONE pass replaces the numpy LUT gather +
// per-column shift packs + whitelist searchsorted (~37ms per 65k-read
// batch — the count row is host-core bound, PERF.md c13).
// Per row i of arr [n, ml] (raw R1 prefix bytes, 0xFF rows = too-short):
//   status[i]: 0 = exact (bckey/ukey set), 1 = short, 2 = clean
//              non-member (pkbc/pkumi set; batched whitelist correction),
//              3 = non-ACGT (python per-row path)
//   pkbc/pkumi: 2-bit packed barcode (bl bases) / UMI (ml - bl bases),
//               valid for status 0 and 2
// wl: ascending packed whitelist, m entries.  has_wl == 0: clean rows
// are exact at face value (no whitelist), matching the numpy path.
// Returns the number of short rows.
int64_t pa_count_r1keys(const uint8_t* arr, int64_t n, int32_t ml,
                        int32_t bl, const uint64_t* wl, int64_t m,
                        int32_t has_wl, int64_t* bckey, int64_t* ukey,
                        uint8_t* status, uint64_t* pkbc, uint64_t* pkumi) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 0xFF, sizeof(lut));
    lut['A'] = 0; lut['C'] = 1; lut['G'] = 2; lut['T'] = 3;
    init = true;
  }
  int64_t n_short = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* row = arr + i * ml;
    bckey[i] = -1;
    ukey[i] = -1;
    pkbc[i] = 0;
    pkumi[i] = 0;
    if (row[0] == 0xFF) { status[i] = 1; n_short++; continue; }
    // the two regions pack independently: a dirty barcode with a clean
    // UMI still needs its packed UMI downstream (the per-row python
    // path reuses pkumi when the UMI bases are all ACGT)
    uint64_t bc = 0, um = 0;
    bool bad_bc = false, bad_um = false;
    for (int32_t j = 0; j < bl; j++) {
      uint8_t c = lut[row[j]];
      if (c == 0xFF) { bad_bc = true; c = 0; }
      bc = (bc << 2) | c;
    }
    for (int32_t j = bl; j < ml; j++) {
      uint8_t c = lut[row[j]];
      if (c == 0xFF) { bad_um = true; c = 0; }
      um = (um << 2) | c;
    }
    pkbc[i] = bad_bc ? 0 : bc;
    pkumi[i] = bad_um ? 0 : um;
    if (bad_bc || bad_um) { status[i] = 3; continue; }
    bool exact;
    if (has_wl) {
      int64_t lo = 0, hi = m;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (wl[mid] < bc) lo = mid + 1; else hi = mid;
      }
      exact = lo < m && wl[lo] == bc;
    } else {
      exact = true;
    }
    if (exact) {
      status[i] = 0;
      bckey[i] = (int64_t)bc;
      ukey[i] = (int64_t)um;
    } else {
      status[i] = 2;
    }
  }
  return n_short;
}

}  // extern "C"

extern "C" {

// Format a batch of mapping records in the reference's output style:
//   (flag, "read_id", [e1, e2], cov)\n     (src/pseudoaligner.rs:490)
// ids_concat: newline-free concatenated id bytes with id_offs[n+1] bounds;
// eq_offsets[n+1] bounds into eq_ids.  Returns a malloc'd buffer in *out
// (caller frees via pa_free_buf) and its length, or -1 on alloc failure.
int64_t pa_emit_records(int64_t n, const uint8_t* flags, const int32_t* covs,
                        const char* ids_concat, const int64_t* id_offs,
                        const int64_t* eq_offsets, const uint32_t* eq_ids,
                        char** out) {
  // worst-case sizing: fixed parts + id lengths + 11 bytes per eq id + cov
  int64_t cap = 0;
  for (int64_t i = 0; i < n; i++) {
    cap += 24 + (id_offs[i + 1] - id_offs[i]) +
           12 * (eq_offsets[i + 1] - eq_offsets[i]) + 12;
  }
  char* buf = (char*)malloc((size_t)cap + 16);
  if (!buf) return -1;
  char* p = buf;

  auto put_u32 = [&p](uint64_t v) {
    char tmp[20];
    int t = 0;
    do { tmp[t++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (t) *p++ = tmp[--t];
  };

  for (int64_t i = 0; i < n; i++) {
    if (flags[i]) { memcpy(p, "(true, \"", 8); p += 8; }
    else { memcpy(p, "(false, \"", 9); p += 9; }
    int64_t il = id_offs[i + 1] - id_offs[i];
    memcpy(p, ids_concat + id_offs[i], (size_t)il); p += il;
    memcpy(p, "\", [", 4); p += 4;
    for (int64_t j = eq_offsets[i]; j < eq_offsets[i + 1]; j++) {
      if (j > eq_offsets[i]) { *p++ = ','; *p++ = ' '; }
      put_u32(eq_ids[j]);
    }
    memcpy(p, "], ", 3); p += 3;
    put_u32((uint32_t)covs[i]);
    *p++ = ')';
    *p++ = '\n';
  }
  *out = buf;
  return p - buf;
}

void pa_free_buf(char* p) { free(p); }

// 2-bit read packing: [B, L] base codes -> [B, ceil(L/16)] uint32 words
// (little-endian 2-bit groups) — the host->device transfer format.  The
// NumPy version measured ~14ms per 65k-read batch on the serving path.
void pa_pack_reads(const uint8_t* codes, int64_t B, int64_t L,
                   uint32_t* out) {
  int64_t nw = (L + 15) / 16;
  for (int64_t b = 0; b < B; b++) {
    const uint8_t* src = codes + b * L;
    uint32_t* dst = out + b * nw;
    for (int64_t w = 0; w < nw; w++) {
      uint32_t acc = 0;
      int64_t base = w * 16;
      int64_t lim = base + 16 < L ? base + 16 : L;
      for (int64_t i = base; i < lim; i++)
        acc |= (uint32_t)(src[i] & 3) << (2 * (i - base));
      dst[w] = acc;
    }
  }
}

// Signature-indirect record formatting: most reads share one of a few
// thousand distinct EC signatures per batch, so each signature's
// "[e1, e2, ...]" payload is rendered ONCE into an arena and per-read
// emission is a memcpy — the Python side passes group indices instead of
// expanding per-read EC id ranges (which measured ~50ms/batch at B=64k).
// sig_of_read[i] == -1 selects the i-matching overflow override instead
// (ovr_rows ascending).  flag = cov >= cov_thresh && eq empty
// (src/pseudoaligner.rs:455 semantics).
int64_t pa_emit_records_sig(
    int64_t n, const int32_t* covs, int32_t cov_thresh,
    const char* ids_concat, const int64_t* id_offs,
    const int64_t* sig_of_read, int64_t n_sigs, const int64_t* sig_start,
    const uint32_t* sig_flat, const int64_t* ovr_rows, int64_t m,
    const int64_t* ovr_start, const uint32_t* ovr_ids, char** out) {
  auto render_len = [](const uint32_t* ids, int64_t cnt) {
    int64_t l = 0;
    for (int64_t j = 0; j < cnt; j++) {
      uint32_t v = ids[j];
      do { l++; v /= 10; } while (v);
      if (j) l += 2;  // ", "
    }
    return l;
  };
  auto render = [](char* p, const uint32_t* ids, int64_t cnt) {
    for (int64_t j = 0; j < cnt; j++) {
      if (j) { *p++ = ','; *p++ = ' '; }
      uint32_t v = ids[j];
      char tmp[12];
      int t = 0;
      do { tmp[t++] = (char)('0' + v % 10); v /= 10; } while (v);
      while (t) *p++ = tmp[--t];
    }
    return p;
  };

  // arena of pre-rendered signature payloads
  std::vector<int64_t> roff(n_sigs + 1, 0);
  for (int64_t s = 0; s < n_sigs; s++)
    roff[s + 1] = roff[s] +
                  render_len(sig_flat + sig_start[s],
                             sig_start[s + 1] - sig_start[s]);
  std::vector<char> arena(roff[n_sigs]);
  for (int64_t s = 0; s < n_sigs; s++)
    render(arena.data() + roff[s], sig_flat + sig_start[s],
           sig_start[s + 1] - sig_start[s]);

  int64_t cap = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t s = sig_of_read[i];
    cap += 28 + (id_offs[i + 1] - id_offs[i]) +
           (s >= 0 ? roff[s + 1] - roff[s] : 0) + 12;
  }
  for (int64_t v = 0; v < m; v++)
    cap += 12 * (ovr_start[v + 1] - ovr_start[v]);
  char* buf = (char*)malloc((size_t)cap + 16);
  if (!buf) return -1;
  char* p = buf;

  int64_t vi = 0;  // cursor into ovr_rows (ascending)
  for (int64_t i = 0; i < n; i++) {
    int64_t s = sig_of_read[i];
    int64_t eq_len;
    if (s >= 0) {
      eq_len = sig_start[s + 1] - sig_start[s];
    } else {
      while (vi < m && ovr_rows[vi] < i) vi++;
      if (vi >= m || ovr_rows[vi] != i) { free(buf); return -2; }
      eq_len = ovr_start[vi + 1] - ovr_start[vi];
    }
    bool flag = covs[i] >= cov_thresh && eq_len == 0;
    if (flag) { memcpy(p, "(true, \"", 8); p += 8; }
    else { memcpy(p, "(false, \"", 9); p += 9; }
    int64_t il = id_offs[i + 1] - id_offs[i];
    memcpy(p, ids_concat + id_offs[i], (size_t)il); p += il;
    memcpy(p, "\", [", 4); p += 4;
    if (s >= 0) {
      memcpy(p, arena.data() + roff[s], (size_t)(roff[s + 1] - roff[s]));
      p += roff[s + 1] - roff[s];
    } else {
      p = render(p, ovr_ids + ovr_start[vi], eq_len);
    }
    memcpy(p, "], ", 3); p += 3;
    uint32_t v = (uint32_t)covs[i];
    char tmp[12];
    int t = 0;
    do { tmp[t++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (t) *p++ = tmp[--t];
    *p++ = ')';
    *p++ = '\n';
  }
  *out = buf;
  return p - buf;
}

}  // extern "C"
