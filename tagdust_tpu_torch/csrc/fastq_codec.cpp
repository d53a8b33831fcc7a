// Native FASTQ codec: fast parse/encode of FASTQ buffers into flat arrays.
//
// The reference outsources decompression to child processes and parses with
// a per-line state machine (io.c:459-606, :1684-1815); the Python fallback
// in tagdust_tpu.io.fastq mirrors that line-state machine.  This codec is
// the hot-path replacement: one pass over a raw buffer producing columnar
// output (names / 0-5 seq codes / quality bytes copied into flat arenas with
// offsets), using the same line-state grammar:
//   - a line starting '@' or '>' (when no record part is pending) starts a
//     record; the NEXT line is the sequence, whatever it contains;
//   - a line starting '+' (when nothing pending) announces that the NEXT
//     line is the quality string (checked same-length as the sequence);
//   - other lines between records are ignored;
//   - empty sequence/quality lines are valid (length 0), matching the
//     reference parser which assigns line content by state, not by content.

#include <cstdint>
#include <cstring>

namespace {
uint8_t NUC[256];
bool nuc_init_done = false;
void nuc_init() {
    if (nuc_init_done) return;
    for (int i = 0; i < 256; i++) NUC[i] = 4;
    NUC['.'] = 5;
    NUC['A'] = 0; NUC['a'] = 0;
    NUC['C'] = 1; NUC['c'] = 1;
    NUC['G'] = 2; NUC['g'] = 2;
    NUC['T'] = 3; NUC['t'] = 3;
    NUC['U'] = 3; NUC['u'] = 3;
    nuc_init_done = true;
}

// Scan one line starting at pos.  Sets [*ls, *le) = content excluding the
// line terminator and any trailing '\r' (mirroring rstrip(b"\r\n")).
// Returns the position after the '\n', or -1 when the line has no terminator
// and !at_eof (i.e. it may be truncated: wait for more data).
long scan_line(const char* buf, long n, long pos, int at_eof, long* ls,
               long* le) {
    long p = pos;
    while (p < n && buf[p] != '\n') p++;
    if (p >= n && !at_eof) return -1;
    long end = p;
    while (end > pos && buf[end - 1] == '\r') end--;
    *ls = pos;
    *le = end;
    return p < n ? p + 1 : n;
}
}  // namespace

extern "C" {

// Parse up to max_records records from buf[0..n) into columnar arenas.
// Returns the number of records parsed, or -1 on a sequence/quality length
// mismatch; *consumed = bytes consumed (callers stream the unconsumed tail
// into the next call).  qual_len = -1 marks an absent quality line (FASTA /
// truncated record); 0 is a present, empty quality line.  Arena capacities
// of n bytes are always sufficient (copied content is a subset of buf).
long td_parse_fastq2(const char* buf, long n, long max_records, int at_eof,
                     uint8_t* name_arena, long* name_off, int* name_len,
                     uint8_t* seq_arena, long seq_arena_cap, long* seq_off,
                     int* seq_len, uint8_t* qual_arena, long* qual_off,
                     int* qual_len, long* consumed) {
    nuc_init();
    long pos = 0;
    long rec = 0;
    long sarena = 0, narena = 0, qarena = 0;
    long committed = 0;  // bytes consumed through the last committed record
    while (pos < n && rec < max_records) {
        long ls, le, p;
        // ---- find a header line ----
        p = scan_line(buf, n, pos, at_eof, &ls, &le);
        if (p < 0) break;
        if (ls >= le || (buf[ls] != '@' && buf[ls] != '>')) {
            pos = p;  // stray line between records: ignored
            continue;
        }
        long hs = ls + 1, he = le;
        // ---- the next line is the sequence (whatever it contains) ----
        long ss = -1, se = -1;
        long after_seq = -1;
        if (p < n || at_eof) {
            if (p >= n) { ss = se = n; after_seq = n; }
            else {
                after_seq = scan_line(buf, n, p, at_eof, &ss, &se);
                if (after_seq < 0) {
                    if (!at_eof) break;
                    ss = se = n; after_seq = n;
                }
            }
        } else break;
        // ---- skip junk until '+', next header, or EOF ----
        long q = after_seq;
        long qs = -1, qe = -1;
        bool have_qual = false;
        bool decided = false;
        while (q < n) {
            long js, je;
            long nx = scan_line(buf, n, q, at_eof, &js, &je);
            if (nx < 0) break;  // truncated line: wait for data
            char c = js < je ? buf[js] : '\0';
            if (c == '@' || c == '>') { decided = true; break; }  // q stays
            if (c == '+') {
                // the line after '+' is the quality, whatever it contains
                if (nx >= n) {
                    if (!at_eof) break;  // qual line not arrived yet
                    q = n;  // EOF right after '+': qual stays absent
                    decided = true;
                    break;
                }
                long nx2 = scan_line(buf, n, nx, at_eof, &qs, &qe);
                if (nx2 < 0) break;
                have_qual = true;
                q = nx2;
                decided = true;
                break;
            }
            q = nx;  // ignored junk line
        }
        if (!decided && !(at_eof && q >= n)) break;  // need more data
        // ---- commit ----
        long slen = se - ss;
        long nlen = he - hs;
        if (sarena + slen > seq_arena_cap) break;
        if (have_qual && (qe - qs) != slen) return -1;
        memcpy(name_arena + narena, buf + hs, (size_t)nlen);
        name_off[rec] = narena;
        name_len[rec] = (int)nlen;
        narena += nlen;
        seq_off[rec] = sarena;
        seq_len[rec] = (int)slen;
        for (long i = 0; i < slen; i++)
            seq_arena[sarena + i] = NUC[(unsigned char)buf[ss + i]];
        sarena += slen;
        if (have_qual) {
            long ql = qe - qs;
            memcpy(qual_arena + qarena, buf + qs, (size_t)ql);
            qual_off[rec] = qarena;
            qual_len[rec] = (int)ql;
            qarena += ql;
        } else {
            qual_off[rec] = qarena;
            qual_len[rec] = -1;
        }
        rec++;
        pos = q;
        committed = q;
    }
    *consumed = committed;
    return rec;
}

// Decode 0-5 codes to ASCII (A C G T N N); 65 (spacer) -> 'N' is NOT mapped
// here: spacers are handled by the writer.
void td_decode_seq(const uint8_t* codes, long n, char* out) {
    static const char alpha[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
    for (long i = 0; i < n; i++) out[i] = alpha[codes[i] > 5 ? 4 : codes[i]];
}

// Skip up to max_records records: the same line-state grammar as
// td_parse_fastq2 but without arena copies or nuc encoding — multi-host
// input sharding uses this so a process pays only boundary-scan cost for
// chunks another host owns (the cross-host analogue of the reference's
// per-thread slice ownership, barcode_hmm.c:1911-1922).  Returns the
// number of complete records skipped; *consumed = bytes through the last
// complete record.
long td_skip_fastq(const char* buf, long n, long max_records, int at_eof,
                   long* consumed) {
    long pos = 0;
    long rec = 0;
    long committed = 0;
    while (pos < n && rec < max_records) {
        long ls, le, p;
        p = scan_line(buf, n, pos, at_eof, &ls, &le);
        if (p < 0) break;
        if (ls >= le || (buf[ls] != '@' && buf[ls] != '>')) {
            pos = p;
            continue;
        }
        long ss = 0, se = 0;
        long after_seq;
        if (p >= n) {
            if (!at_eof) break;
            after_seq = n;
        } else {
            after_seq = scan_line(buf, n, p, at_eof, &ss, &se);
            if (after_seq < 0) {
                if (!at_eof) break;
                after_seq = n;
            }
        }
        long q = after_seq;
        bool decided = false;
        bool have_qual = false;
        long qs2 = 0, qe2 = 0;
        while (q < n) {
            long js, je;
            long nx = scan_line(buf, n, q, at_eof, &js, &je);
            if (nx < 0) break;
            char c = js < je ? buf[js] : '\0';
            if (c == '@' || c == '>') { decided = true; break; }
            if (c == '+') {
                if (nx >= n) {
                    if (!at_eof) break;
                    q = n;
                    decided = true;
                    break;
                }
                long nx2 = scan_line(buf, n, nx, at_eof, &qs2, &qe2);
                if (nx2 < 0) break;
                have_qual = true;
                q = nx2;
                decided = true;
                break;
            }
            q = nx;
        }
        if (!decided && !(at_eof && q >= n)) break;
        // mirror td_parse_fastq2's malformed-record rejection: a skipping
        // host must abort on the same inputs the owning host aborts on,
        // or a multi-host run would hang at the next collective with one
        // process dead (ADVICE round 3)
        if (have_qual && (qe2 - qs2) != (se - ss)) return -1;
        rec++;
        pos = q;
        committed = q;
    }
    *consumed = committed;
    return rec;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native demultiplexed-output emitter: the hot half of print_all
// (io.c:757-1016).  Splits each read's post-extraction code string on
// >=5-valued separators (65-spacers between multiple R segments), routes run
// k of read i to fd[file_base[i] + k*n_alt], and writes
//   @<name>[;FP:<key|seq>];RQ:<q.2f>\n<SEQ>\n+\n<QUAL>\n
// with per-file buffering and direct write() syscalls (the Python writer
// formats the identical bytes; gold tests pin the equality).
// ---------------------------------------------------------------------------

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <unistd.h>

namespace {
struct OutBuf {
    uint8_t* data;
    long used;
    long cap;
    int fd;
};

bool flush_buf(OutBuf* b) {
    long off = 0;
    while (off < b->used) {
        ssize_t w = write(b->fd, b->data + off, (size_t)(b->used - off));
        if (w < 0) {
            if (errno == EINTR) continue;
            return false;
        }
        off += w;
    }
    b->used = 0;
    return true;
}

bool put_bytes(OutBuf* b, const uint8_t* p, long n) {
    if (n > b->cap) {
        if (!flush_buf(b)) return false;
        long off = 0;
        while (off < n) {
            ssize_t w = write(b->fd, p + off, (size_t)(n - off));
            if (w < 0) {
                if (errno == EINTR) continue;
                return false;
            }
            off += w;
        }
        return true;
    }
    if (b->used + n > b->cap && !flush_buf(b)) return false;
    memcpy(b->data + b->used, p, (size_t)n);
    b->used += n;
    return true;
}

bool put_seq(OutBuf* b, const uint8_t* codes, long n) {
    static const char alpha[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
    long done = 0;
    while (done < n) {
        long chunk = n - done;
        if (b->used + chunk > b->cap) {
            if (b->used && !flush_buf(b)) return false;
            if (chunk > b->cap) chunk = b->cap;
        }
        for (long i = 0; i < chunk; i++)
            b->data[b->used + i] =
                (uint8_t)alpha[codes[done + i] > 5 ? 4 : codes[done + i]];
        b->used += chunk;
        done += chunk;
    }
    return true;
}
}  // namespace

extern "C" {

// Returns 0 on success, -1 on a write error (errno preserved for the
// caller), -2 on allocation failure.
long td_emit_runs(const uint8_t* name_arena, const long* name_off,
                  const uint8_t* seq_arena, const long* seq_off,
                  const uint8_t* qual_arena, const long* qual_off,
                  const long* qual_len, const double* mapq, const long* fp,
                  int print_seq_finger, const long* file_base, long B,
                  long n_alt, const int* fds, long n_files) {
    const long BUFCAP = 1 << 16;
    OutBuf* bufs = (OutBuf*)malloc(sizeof(OutBuf) * (size_t)n_files);
    if (!bufs) return -2;
    uint8_t* pool = (uint8_t*)malloc((size_t)(BUFCAP * n_files));
    if (!pool) { free(bufs); return -2; }
    for (long f = 0; f < n_files; f++) {
        bufs[f].data = pool + BUFCAP * f;
        bufs[f].used = 0;
        bufs[f].cap = BUFCAP;
        bufs[f].fd = fds[f];
    }
    char hdr[4096];
    bool ok = true;
    for (long i = 0; i < B && ok; i++) {
        long ns = name_off[i], ne = name_off[i + 1];
        long ss = seq_off[i], se = seq_off[i + 1];
        long nlen = ne - ns;
        // header tail after the name: [;FP:..];RQ:..\n
        int hl = 0;
        if (fp[i] != -1) {
            if (print_seq_finger) {
                long v = fp[i];
                int len = (int)(v & 0xFF);
                unsigned long long key = (unsigned long long)v >> 8;
                char fpseq[260];
                for (int k2 = len - 1; k2 >= 0; k2--) {
                    fpseq[k2] = "ACGTN"[key & 0x3];
                    key >>= 2;
                }
                fpseq[len < 0 ? 0 : len] = 0;
                hl = snprintf(hdr, sizeof hdr, ";FP:%s;RQ:%.2f\n", fpseq,
                              mapq[i]);
            } else {
                hl = snprintf(hdr, sizeof hdr, ";FP:%ld;RQ:%.2f\n", fp[i],
                              mapq[i]);
            }
        } else {
            hl = snprintf(hdr, sizeof hdr, ";RQ:%.2f\n", mapq[i]);
        }
        if (hl < 0 || hl >= (int)sizeof hdr) { ok = false; break; }
        long run_k = 0;
        long j = ss;
        while (j < se && ok) {
            while (j < se && seq_arena[j] >= 5) j++;
            if (j >= se) break;
            long r0 = j;
            while (j < se && seq_arena[j] < 5) j++;
            long fidx = file_base[i] + run_k * n_alt;
            OutBuf* b = &bufs[fidx];
            ok = ok && put_bytes(b, (const uint8_t*)"@", 1);
            ok = ok && put_bytes(b, name_arena + ns, nlen);
            ok = ok && put_bytes(b, (const uint8_t*)hdr, hl);
            ok = ok && put_seq(b, seq_arena + r0, j - r0);
            ok = ok && put_bytes(b, (const uint8_t*)"\n+\n", 3);
            if (qual_len[i] >= 0) {
                ok = ok && put_bytes(
                    b, qual_arena + qual_off[i] + (r0 - ss), j - r0);
            } else {
                // FASTA input: '.'-filled quality (io.c:966 behaviour)
                for (long d = r0; d < j && ok; d++)
                    ok = put_bytes(b, (const uint8_t*)".", 1);
            }
            ok = ok && put_bytes(b, (const uint8_t*)"\n", 1);
            run_k++;
        }
    }
    for (long f = 0; f < n_files; f++)
        if (!flush_buf(&bufs[f])) ok = false;
    free(pool);
    free(bufs);
    return ok ? 0 : -1;
}

}  // extern "C"
