// Native streaming gzip source — the gz twin of the mmap'd plain-file
// scanner input (reference: src/utils.rs:147-157 [dep] opens plain or
// gz FASTQs via flate2; here the inflate runs on dedicated NATIVE
// threads so it never contends with the Python serving loop for the GIL:
// the measured single-stream inflate cost (~25-60ms per 65k-read batch)
// must overlap the device step, and Python-thread handoff jitter was
// enough to drain the FIFO dispatch pipeline (PERF.md round 4)).
//
// Producer thread: fread -> inflate -> bounded block queue (byte-capped).
// Consumer (ctypes, GIL released): pa_gz_fill copies queued blocks into
// the caller's growable scan buffer and reports the end of the last
// complete line, mirroring the Python _GzScanBuffer contract.
//
// Multi-member gzip (bgzf-style concatenation) is handled by
// inflateReset after each member end.  BGZF members (the common real
// sequencing-data container: each member's gzip FEXTRA carries a 'BC'
// subfield with the compressed block size) additionally inflate IN
// PARALLEL (VERDICT r4 #5): the producer parses member headers, skips
// ahead by BSIZE without inflating, and fans complete members out to a
// small worker pool; an ordered reorder buffer delivers blocks in file
// order, so the consumer contract (including deliver-then-error on a
// corrupt member) is unchanged.  Non-BGZF members fall back to the
// serial streaming inflate mid-file.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct MemberTask {
  uint64_t seq;
  std::vector<uint8_t> comp;  // full member bytes (header..trailer)
  uint32_t isize;             // uncompressed size from the trailer
};

struct MemberResult {
  std::vector<uint8_t> out;
  bool failed = false;
  char msg[160] = {0};
};

struct PaGz {
  std::FILE* f = nullptr;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv_data;   // producer -> consumer
  std::condition_variable cv_space;  // consumer -> producer
  std::deque<std::vector<uint8_t>> blocks;
  size_t front_off = 0;  // consumed prefix of blocks.front()
  size_t queued = 0;     // total unconsumed bytes across blocks
  size_t ahead_cap = 32u << 20;
  size_t chunk = 1u << 20;
  bool eof = false;              // producer finished (clean or error)
  std::atomic<bool> stop{false};  // consumer closed (read lock-free)
  int err = 0;
  char msg[160] = {0};

  // --- parallel (BGZF) mode state ---
  int n_workers = 0;
  std::vector<std::thread> workers;
  std::mutex tmu;
  std::condition_variable cv_task;  // producer -> workers
  std::condition_variable cv_done;  // workers -> deliverer
  std::deque<MemberTask> tasks;
  std::map<uint64_t, MemberResult> done;
  uint64_t outstanding = 0;  // tasks queued or being inflated
  bool tasks_closed = false;

  void fail(const char* m) {
    std::lock_guard<std::mutex> g(mu);
    if (!err) {
      err = 1;
      snprintf(msg, sizeof(msg), "%s", m);
    }
    eof = true;
    cv_data.notify_all();
  }

  void push(std::vector<uint8_t>&& block) {
    std::unique_lock<std::mutex> g(mu);
    cv_space.wait(g, [&] { return queued < ahead_cap || stop; });
    if (stop) return;
    queued += block.size();
    blocks.emplace_back(std::move(block));
    cv_data.notify_all();
  }

  // ---- serial streaming inflate (non-BGZF path; also the mid-file
  // fallback after BGZF members stop).  `carry` holds bytes already
  // read from f (e.g. a parsed-but-not-BGZF header). ----
  void run_serial(std::vector<uint8_t> carry) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 31) != Z_OK) {
      fail("inflateInit2 failed");
      return;
    }
    std::vector<uint8_t> in(chunk);
    bool fed = false;  // bytes fed into the CURRENT member
    const size_t out_cap = chunk * 4;
    bool use_carry = !carry.empty();
    while (!stop) {
      size_t got;
      if (use_carry) {
        got = carry.size();
        if (got > in.size()) in.resize(got);
        memcpy(in.data(), carry.data(), got);
        use_carry = false;
      } else {
        got = fread(in.data(), 1, chunk, f);
      }
      if (got == 0) {
        if (ferror(f)) {
          fail("gzip source read error");
        } else if (fed) {
          // file ended mid-member: truncated stream
          fail("truncated gzip stream");
        } else {
          std::lock_guard<std::mutex> g(mu);
          eof = true;
          cv_data.notify_all();
        }
        break;
      }
      zs.next_in = in.data();
      zs.avail_in = (uInt)got;
      while (zs.avail_in > 0 && !stop) {
        fed = true;
        std::vector<uint8_t> out(out_cap);
        zs.next_out = out.data();
        zs.avail_out = (uInt)out.size();
        int rc = inflate(&zs, Z_NO_FLUSH);
        size_t produced = out.size() - zs.avail_out;
        if (produced) {
          out.resize(produced);
          // right-size before queueing: a bgzf-style file (~64KB per
          // member) would otherwise pin out_cap of heap per block while
          // `queued` counts only the bytes — ahead_cap admits hundreds
          if (out.capacity() > produced + 4096) out.shrink_to_fit();
          push(std::move(out));
        }
        if (rc == Z_STREAM_END) {
          // next gzip member (concatenated/bgzf files)
          if (inflateReset(&zs) != Z_OK) {
            fail("inflateReset failed");
            break;
          }
          fed = false;
        } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
          fail(zs.msg ? zs.msg : "gzip inflate error");
          break;
        }
      }
      if (err) break;
    }
    inflateEnd(&zs);
    if (stop && !eof) {
      std::lock_guard<std::mutex> g(mu);
      eof = true;
      cv_data.notify_all();
    }
  }

  // ---- BGZF parallel mode ----

  // read exactly n more bytes into buf (appending); false on short read
  bool read_exact(std::vector<uint8_t>& buf, size_t n) {
    size_t base = buf.size();
    buf.resize(base + n);
    size_t got = fread(buf.data() + base, 1, n, f);
    if (got != n) {
      buf.resize(base + got);
      return false;
    }
    return true;
  }

  void worker_loop() {
    // ONE z_stream per worker, inflateReset between members: a full
    // inflateInit2/inflateEnd cycle per ~64KB member paid zlib's state
    // allocation tens of thousands of times per second (review r5)
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    bool zs_ok = inflateInit2(&zs, 31) == Z_OK;
    for (;;) {
      MemberTask t;
      {
        std::unique_lock<std::mutex> g(tmu);
        cv_task.wait(g, [&] { return !tasks.empty() || tasks_closed || stop; });
        if (stop) break;
        if (tasks.empty()) {
          if (tasks_closed) break;
          continue;
        }
        t = std::move(tasks.front());
        tasks.pop_front();
      }
      MemberResult r;
      if ((uint64_t)t.isize > (1u << 16)) {
        // the trailer ISIZE is UNTRUSTED input: BGZF blocks decompress
        // to <= 64KB (htslib bound), so a bigger claim is corruption —
        // resizing to it would zero-fill GBs and a failed allocation
        // in a thread body would std::terminate the whole process
        // (review r5)
        r.failed = true;
        snprintf(r.msg, sizeof(r.msg),
                 "corrupt BGZF member: claimed %llu uncompressed bytes "
                 "(> 64KB block bound)", (unsigned long long)t.isize);
      } else if (!zs_ok) {
        r.failed = true;
        snprintf(r.msg, sizeof(r.msg), "inflateInit2 failed");
      } else {
        // isize sizes the output; +1 spare byte so an EMPTY member
        // doesn't hand inflate avail_out=0 (an instant Z_BUF_ERROR)
        // and so a lying small trailer is detected as leftover input
        // rather than mis-read as clean
        r.out.resize((size_t)t.isize + 1);
        zs.next_in = t.comp.data();
        zs.avail_in = (uInt)t.comp.size();
        zs.next_out = r.out.data();
        zs.avail_out = (uInt)r.out.size();
        int rc = inflate(&zs, Z_FINISH);
        if (rc != Z_STREAM_END) {
          // Z_OK/Z_BUF_ERROR here = output didn't reach stream end in
          // isize bytes -> lying trailer; anything else = corrupt data
          r.failed = true;
          snprintf(r.msg, sizeof(r.msg), "%s",
                   zs.msg ? zs.msg : "gzip inflate error");
        } else if (zs.avail_in != 0) {
          // an overstated BSIZE makes the claimed block span the NEXT
          // member: accepting it would silently drop that member's
          // records with no error ever raised (review r5)
          r.failed = true;
          snprintf(r.msg, sizeof(r.msg),
                   "corrupt BGZF member: %u bytes left after stream end",
                   (unsigned)zs.avail_in);
        } else if (zs.avail_out != 0) {
          r.out.resize(r.out.size() - zs.avail_out);
        }
        if (inflateReset(&zs) != Z_OK) {
          inflateEnd(&zs);
          memset(&zs, 0, sizeof(zs));
          zs_ok = inflateInit2(&zs, 31) == Z_OK;
        }
      }
      {
        std::lock_guard<std::mutex> g(tmu);
        done.emplace(t.seq, std::move(r));
        cv_done.notify_all();
      }
    }
    if (zs_ok) inflateEnd(&zs);
  }

  // deliver completed members to the consumer queue in file order;
  // returns false if a member failed (error already reported) or the
  // consumer closed.  Called only by the producer thread.
  bool deliver_until(uint64_t upto_exclusive) {
    uint64_t next = 0;
    {
      std::lock_guard<std::mutex> g(tmu);
      next = delivered;
    }
    while (next < upto_exclusive && !stop) {
      MemberResult r;
      {
        std::unique_lock<std::mutex> g(tmu);
        cv_done.wait(g, [&] {
          return done.find(delivered) != done.end() || stop;
        });
        if (stop) return false;
        auto it = done.find(delivered);
        r = std::move(it->second);
        done.erase(it);
        delivered++;
        outstanding--;
        next = delivered;
        cv_task.notify_all();  // capacity freed
      }
      if (r.failed) {
        fail(r.msg);
        return false;
      }
      if (!r.out.empty()) push(std::move(r.out));
    }
    return !stop;
  }

  uint64_t delivered = 0;  // members handed to the consumer queue
  uint64_t enq = 0;        // members enqueued to workers

  // Parse one member header already partially read into `hdr` (>= what
  // has been read so far).  On success returns the member's total size
  // via *bsize_out (BGZF 'BC' subfield) and leaves hdr holding exactly
  // the consumed header bytes; returns:
  //   1 = BGZF member, 0 = valid-looking gzip but not BGZF (serial
  //   fallback takes over with hdr as carry), -1 = EOF cleanly before
  //   any byte, -2 = truncated, -3 = corrupt (bad magic / lying BSIZE)
  int parse_member_header(std::vector<uint8_t>& hdr, size_t* bsize_out) {
    hdr.clear();
    size_t got0 = 0;
    hdr.resize(12);
    got0 = fread(hdr.data(), 1, 12, f);
    hdr.resize(got0);
    if (got0 == 0) return ferror(f) ? -2 : -1;
    if (got0 < 12) return -2;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8) return -3;
    uint8_t flg = hdr[3];
    if ((flg & 0x04) == 0) return 0;  // no FEXTRA: not BGZF
    size_t xlen = (size_t)hdr[10] | ((size_t)hdr[11] << 8);
    if (!read_exact(hdr, xlen)) return -2;
    // scan subfields for 'BC' (SLEN == 2)
    size_t p = 12;
    size_t end = 12 + xlen;
    while (p + 4 <= end) {
      uint8_t si1 = hdr[p], si2 = hdr[p + 1];
      size_t slen = (size_t)hdr[p + 2] | ((size_t)hdr[p + 3] << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2 && p + 6 <= end) {
        size_t bsize =
            ((size_t)hdr[p + 4] | ((size_t)hdr[p + 5] << 8)) + 1;
        if (bsize < end + 8) return -3;  // smaller than its own header
        *bsize_out = bsize;
        return 1;
      }
      p += 4 + slen;
    }
    return 0;  // FEXTRA without BC: not BGZF
  }

  void run() {
    // Peek the first member: BGZF -> parallel mode; anything else ->
    // the serial streaming path (identical to the pre-r5 behavior).
    std::vector<uint8_t> hdr;
    size_t bsize = 0;
    int kind = parse_member_header(hdr, &bsize);
    if (kind == -1) {
      std::lock_guard<std::mutex> g(mu);
      eof = true;
      cv_data.notify_all();
      return;
    }
    if (kind == -2 && hdr.empty() && ferror(f)) {
      fail("gzip source read error");
      return;
    }
    if (kind != 1) {
      // kind 0/-2/-3: the serial inflate reports the precise zlib error
      run_serial(std::move(hdr));
      return;
    }

    // BGZF: spin the worker pool lazily (only for files that are BGZF).
    // Default 1 worker on narrow (<= 4 core) hosts: the serving loop's
    // render/remap/scan threads saturate those cores and extra inflate
    // workers measurably SINK the gz serving ratio (chip A/B c24:
    // 2 workers 0.59-0.78 vs 1 worker 0.75-0.91 of plain) — reader-only
    // parallel speedup (170 -> ~950MB/s) is for wide hosts.
    unsigned hw = std::thread::hardware_concurrency();
    n_workers = (int)(hw > 4 ? (hw - 4 < 3 ? hw - 4 : 3) : 1);
    const char* envw = getenv("PA_GZ_WORKERS");
    if (envw && envw[0]) {
      int v = atoi(envw);
      if (v >= 1 && v <= 16) n_workers = v;
    }
    for (int i = 0; i < n_workers; i++)
      workers.emplace_back([this] { worker_loop(); });
    const uint64_t max_outstanding = (uint64_t)n_workers * 4 + 8;

    bool failed = false;
    for (;;) {
      if (stop) break;
      // read the member body (header already in hdr, bsize total)
      MemberTask t;
      t.seq = enq;
      t.comp = std::move(hdr);
      size_t remain = bsize - t.comp.size();
      if (!read_exact(t.comp, remain) || t.comp.size() < 18 + 8) {
        // deliver everything before the corruption point first
        deliver_until(enq);
        fail(ferror(f) ? "gzip source read error"
                       : "truncated gzip stream");
        failed = true;
        break;
      }
      const uint8_t* tr = t.comp.data() + t.comp.size() - 4;
      t.isize = (uint32_t)tr[0] | ((uint32_t)tr[1] << 8) |
                ((uint32_t)tr[2] << 16) | ((uint32_t)tr[3] << 24);
      // admission + ordered delivery: capacity frees only when results
      // DELIVER, so the capacity wait must itself drain ready results —
      // a plain "wait for capacity" deadlocks once the pipeline fills
      // (workers done, nobody delivering; caught by the native driver)
      {
        std::unique_lock<std::mutex> g(tmu);
        for (;;) {
          while (!stop) {  // drain everything ready, in order
            auto it = done.find(delivered);
            if (it == done.end()) break;
            MemberResult r = std::move(it->second);
            done.erase(it);
            delivered++;
            outstanding--;
            g.unlock();
            if (r.failed) {
              fail(r.msg);
              failed = true;
            } else if (!r.out.empty()) {
              push(std::move(r.out));
            }
            g.lock();
            if (failed) break;
          }
          if (failed || stop) break;
          if (outstanding < max_outstanding) break;
          cv_done.wait(g, [&] {
            return stop || done.find(delivered) != done.end();
          });
        }
        if (!failed && !stop) {
          outstanding++;
          enq++;
          tasks.emplace_back(std::move(t));
          cv_task.notify_one();
        }
      }
      if (failed || stop) break;
      // next member header
      kind = parse_member_header(hdr, &bsize);
      if (kind == 1) continue;
      if (kind == -1) {  // clean EOF: flush the tail in order
        if (deliver_until(enq)) {
          std::lock_guard<std::mutex> g(mu);
          eof = true;
          cv_data.notify_all();
        }
        break;
      }
      if (kind == -2 || kind == -3) {
        deliver_until(enq);
        fail(ferror(f) ? "gzip source read error"
                       : (kind == -3 ? "corrupt gzip member header"
                                     : "truncated gzip stream"));
        failed = true;
        break;
      }
      // kind == 0: a non-BGZF member mid-file — drain the parallel
      // pipeline, then continue serially from here
      if (!deliver_until(enq)) break;
      run_serial(std::move(hdr));
      break;
    }
    // wind down workers
    {
      std::lock_guard<std::mutex> g(tmu);
      tasks_closed = true;
      cv_task.notify_all();
    }
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
    if (stop && !eof) {
      std::lock_guard<std::mutex> g(mu);
      eof = true;
      cv_data.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* pa_gz_open(const char* path, int64_t chunk, int64_t ahead_bytes) {
  PaGz* h = new PaGz();
  h->f = std::fopen(path, "rb");
  if (!h->f) {
    delete h;
    return nullptr;
  }
  if (chunk > 0) h->chunk = (size_t)chunk;
  if (ahead_bytes > 0) h->ahead_cap = (size_t)ahead_bytes;
  h->th = std::thread([h] { h->run(); });
  return h;
}

// Append queued decompressed bytes into dst[cur_len:cap] until
// (cur_len + appended) >= min_len, dst is full, or the stream ends.
// Outputs:
//   return        — bytes appended (>= 0), or -1 on stream error
//   *last_nl      — offset (within dst) ONE PAST the last '\n' in the
//                   appended region, or -1 if it contains none
//   *eof_out      — 1 iff the stream is exhausted AND all bytes consumed
//   errbuf        — error message on -1
int64_t pa_gz_fill(void* hv, uint8_t* dst, int64_t cap, int64_t cur_len,
                   int64_t min_len, int64_t* last_nl, int32_t* eof_out,
                   char* errbuf, int64_t errcap) {
  PaGz* h = (PaGz*)hv;
  int64_t appended = 0;
  *last_nl = -1;
  *eof_out = 0;
  std::unique_lock<std::mutex> g(h->mu);
  for (;;) {
    while (h->queued == 0 && !h->eof) h->cv_data.wait(g);
    // on error: deliver already-inflated bytes FIRST (matching the
    // Python fallback, whose queue holds chunks then the exception) —
    // the error is reported on the next call, once the queue is dry
    if (h->err && h->queued == 0) {
      if (appended > 0) break;
      snprintf(errbuf, (size_t)errcap, "%s", h->msg);
      return -1;
    }
    // drain as much as fits / is needed
    while (h->queued > 0 && cur_len + appended < cap) {
      std::vector<uint8_t>& blk = h->blocks.front();
      size_t avail = blk.size() - h->front_off;
      size_t space = (size_t)(cap - cur_len - appended);
      size_t take = avail < space ? avail : space;
      memcpy(dst + cur_len + appended, blk.data() + h->front_off, take);
      appended += (int64_t)take;
      h->front_off += take;
      h->queued -= take;
      if (h->front_off == blk.size()) {
        h->blocks.pop_front();
        h->front_off = 0;
      }
    }
    h->cv_space.notify_all();
    if (cur_len + appended >= min_len) break;
    if (cur_len + appended >= cap) break;  // caller must grow dst
    if (h->eof && h->queued == 0) break;
  }
  // never signal clean eof while an error is pending — the consumer
  // would treat the stream as complete and silently truncate
  if (h->eof && h->queued == 0 && !h->err) *eof_out = 1;
  if (appended > 0) {
    const uint8_t* beg = dst + cur_len;
    for (int64_t i = appended - 1; i >= 0; i--) {  // memrchr is GNU-only
      if (beg[i] == '\n') {
        *last_nl = cur_len + i + 1;
        break;
      }
    }
  }
  return appended;
}

void pa_gz_close(void* hv) {
  PaGz* h = (PaGz*)hv;
  {
    std::lock_guard<std::mutex> g(h->mu);
    h->stop = true;
    h->cv_space.notify_all();
    h->cv_data.notify_all();
  }
  {
    std::lock_guard<std::mutex> g(h->tmu);
    h->cv_task.notify_all();
    h->cv_done.notify_all();
  }
  if (h->th.joinable()) h->th.join();
  if (h->f) std::fclose(h->f);
  delete h;
}

}  // extern "C"
