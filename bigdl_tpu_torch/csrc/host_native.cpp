// bigdl_tpu_torch host library: the data pipeline's host loops behind a C
// ABI, bound with ctypes by bigdl_tpu_torch/native/__init__.py.
//
// The port's own copy of the JAX package's native runtime: record
// framing CRCs (ref netty/Crc32c.java), the Torch-compatible MT19937
// (ref utils/RandomGenerator.scala:23-265), record-shard and Hadoop
// SequenceFile indexing for the data loader (ref dataset/DataSet.scala
// :380-433), the word tokenizer and the crop/flip/pack image batcher.
// It runs on the host CPU, never on the card.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -pthread -o <lib>.so host_native.cpp
// No external dependencies.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>

#include <pthread.h>

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// --------------------------------------------------------------------- //
// CRC32C (Castagnoli, reflected poly 0x82F63B78), slice-by-8            //
// --------------------------------------------------------------------- //

static uint32_t g_crc_table[8][256];
static bool g_crc_init = false;

static void crc_init_tables() {
    for (int n = 0; n < 256; ++n) {
        uint32_t c = (uint32_t)n;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        g_crc_table[0][n] = c;
    }
    for (int n = 0; n < 256; ++n) {
        uint32_t c = g_crc_table[0][n];
        for (int s = 1; s < 8; ++s) {
            c = g_crc_table[0][c & 0xFF] ^ (c >> 8);
            g_crc_table[s][n] = c;
        }
    }
    g_crc_init = true;
}

uint32_t bt_crc32c(const uint8_t* data, int64_t len, uint32_t crc) {
    if (!g_crc_init) crc_init_tables();
    crc ^= 0xFFFFFFFFu;
    // align-friendly 8-byte slices
    while (len >= 8) {
        uint64_t chunk;
        std::memcpy(&chunk, data, 8);
        crc ^= (uint32_t)chunk;
        uint32_t hi = (uint32_t)(chunk >> 32);
        crc = g_crc_table[7][crc & 0xFF] ^ g_crc_table[6][(crc >> 8) & 0xFF] ^
              g_crc_table[5][(crc >> 16) & 0xFF] ^ g_crc_table[4][crc >> 24] ^
              g_crc_table[3][hi & 0xFF] ^ g_crc_table[2][(hi >> 8) & 0xFF] ^
              g_crc_table[1][(hi >> 16) & 0xFF] ^ g_crc_table[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    while (len-- > 0)
        crc = g_crc_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// --------------------------------------------------------------------- //
// Torch-compatible MT19937 (N=624, M=397) with 53-bit doubles and       //
// polar-method normals (one cached), matching utils/rng.py             //
// --------------------------------------------------------------------- //

struct BtMt {
    uint32_t mt[624];
    int mti;
    double cached;
    int has_cached;
};

static void mt_seed(BtMt* g, uint64_t seed) {
    g->mt[0] = (uint32_t)(seed & 0xFFFFFFFFu);
    for (int i = 1; i < 624; ++i)
        g->mt[i] = 1812433253u * (g->mt[i - 1] ^ (g->mt[i - 1] >> 30)) + (uint32_t)i;
    g->mti = 624;
    g->has_cached = 0;
}

void* bt_mt_new(uint64_t seed) {
    BtMt* g = (BtMt*)std::malloc(sizeof(BtMt));
    mt_seed(g, seed);
    return g;
}

void bt_mt_free(void* p) { std::free(p); }

void bt_mt_set_seed(void* p, uint64_t seed) { mt_seed((BtMt*)p, seed); }

static inline uint32_t mt_next(BtMt* g) {
    if (g->mti >= 624) {
        uint32_t* mt = g->mt;
        for (int i = 0; i < 624; ++i) {
            uint32_t y = (mt[i] & 0x80000000u) | (mt[(i + 1) % 624] & 0x7FFFFFFFu);
            mt[i] = mt[(i + 397) % 624] ^ (y >> 1) ^ ((y & 1u) ? 0x9908B0DFu : 0u);
        }
        g->mti = 0;
    }
    uint32_t y = g->mt[g->mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9D2C5680u;
    y ^= (y << 15) & 0xEFC60000u;
    y ^= y >> 18;
    return y;
}

static inline double mt_random(BtMt* g) {  // 53-bit double in [0,1)
    uint32_t a = mt_next(g) >> 5, b = mt_next(g) >> 6;
    return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0);
}

double bt_mt_random(void* p) { return mt_random((BtMt*)p); }

uint32_t bt_mt_random_int(void* p) { return mt_next((BtMt*)p); }

void bt_mt_uniform(void* p, double* out, int64_t n, double a, double b) {
    BtMt* g = (BtMt*)p;
    for (int64_t i = 0; i < n; ++i)
        out[i] = mt_random(g) * (b - a) + a;
}

static inline double mt_normal(BtMt* g) {
    if (g->has_cached) {
        g->has_cached = 0;
        return g->cached;
    }
    double u, v, s;
    do {
        u = 2.0 * mt_random(g) - 1.0;
        v = 2.0 * mt_random(g) - 1.0;
        s = u * u + v * v;
    } while (s >= 1.0 || s <= 0.0);
    double mult = std::sqrt(-2.0 * std::log(s) / s);
    g->cached = v * mult;
    g->has_cached = 1;
    return u * mult;
}

void bt_mt_normal(void* p, double* out, int64_t n, double mean, double stdv) {
    BtMt* g = (BtMt*)p;
    for (int64_t i = 0; i < n; ++i)
        out[i] = mean + stdv * mt_normal(g);
}

void bt_mt_bernoulli(void* p, double* out, int64_t n, double prob) {
    BtMt* g = (BtMt*)p;
    for (int64_t i = 0; i < n; ++i)
        out[i] = (mt_random(g) <= prob) ? 1.0 : 0.0;
}

void bt_mt_randperm(void* p, int64_t* out, int64_t n) {
    BtMt* g = (BtMt*)p;
    for (int64_t i = 0; i < n; ++i) out[i] = i + 1;  // 1-based, Torch style
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = (int64_t)(mt_random(g) * (double)(i + 1));
        int64_t t = out[i]; out[i] = out[j]; out[j] = t;
    }
}

// state round-trip so the Python generator can hand off / resume exactly
void bt_mt_get_state(void* p, uint32_t* mt, int32_t* mti, double* cached,
                     int32_t* has_cached) {
    BtMt* g = (BtMt*)p;
    std::memcpy(mt, g->mt, sizeof(g->mt));
    *mti = g->mti;
    *cached = g->cached;
    *has_cached = g->has_cached;
}

void bt_mt_set_state(void* p, const uint32_t* mt, int32_t mti, double cached,
                     int32_t has_cached) {
    BtMt* g = (BtMt*)p;
    std::memcpy(g->mt, mt, sizeof(g->mt));
    g->mti = mti;
    g->cached = cached;
    g->has_cached = has_cached;
}

// --------------------------------------------------------------------- //
// Record-shard indexer: one pass over an in-memory (mmapped) shard,     //
// emitting per-record payload offsets/lengths/labels.  Format (LE):     //
//   "BTRS\x01" | { u32 len | u32 crc32 (zlib) | f32 label | payload }*  //
// --------------------------------------------------------------------- //

// zlib-style CRC32 (reflected poly 0xEDB88320) for shard payload checks
static uint32_t g_z_table[256];
static bool g_z_init = false;

static void z_init_table() {
    for (int n = 0; n < 256; ++n) {
        uint32_t c = (uint32_t)n;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (c >> 1) ^ 0xEDB88320u : c >> 1;
        g_z_table[n] = c;
    }
    g_z_init = true;
}

uint32_t bt_crc32(const uint8_t* data, int64_t len, uint32_t crc) {
    if (!g_z_init) z_init_table();
    crc ^= 0xFFFFFFFFu;
    while (len-- > 0)
        crc = g_z_table[(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// returns record count, or -1 on malformed input / -2 on crc mismatch /
// -3 when max_n was reached with data left (caller sized arrays too small)
int64_t bt_shard_index(const uint8_t* buf, int64_t len, int64_t* offsets,
                       int64_t* lengths, float* labels, int64_t max_n,
                       int32_t validate) {
    const int64_t kMagic = 5;
    if (len < kMagic || std::memcmp(buf, "BTRS\x01", kMagic) != 0) return -1;
    int64_t pos = kMagic, n = 0;
    while (pos < len) {
        if (n >= max_n) return -3;
        if (pos + 12 > len) return -1;  // truncated header
        uint32_t plen, crc;
        float label;
        std::memcpy(&plen, buf + pos, 4);
        std::memcpy(&crc, buf + pos + 4, 4);
        std::memcpy(&label, buf + pos + 8, 4);
        pos += 12;
        if (pos + (int64_t)plen > len) return -1;  // truncated payload
        if (validate && bt_crc32(buf + pos, plen, 0) != crc) return -2;
        offsets[n] = pos;
        lengths[n] = plen;
        labels[n] = label;
        pos += plen;
        ++n;
    }
    return n;
}

// --------------------------------------------------------------------- //
// Hadoop SequenceFile indexer: one pass over an in-memory Text/Text     //
// SequenceFile (the reference's ImageNet storage,                        //
// image/BGRImgToLocalSeqFile.scala), emitting per-record value-payload  //
// offsets/lengths and the label parsed from the key ("label" or         //
// "name\nlabel").  Python path: dataset/hadoop_seqfile.py.              //
// --------------------------------------------------------------------- //

static int hseq_vint(const uint8_t* buf, int64_t len, int64_t* pos,
                     int64_t* out) {
    if (*pos >= len) return -1;
    int8_t b = (int8_t)buf[(*pos)++];
    if (b >= -112) { *out = b; return 0; }
    bool neg = b < -120;
    int n = neg ? -(b + 120) : -(b + 112);
    if (*pos + n > len) return -1;
    int64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 8) | buf[(*pos)++];
    *out = neg ? ~v : v;
    return 0;
}

static int32_t be32(const uint8_t* p) {
    return (int32_t)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                     ((uint32_t)p[2] << 8) | (uint32_t)p[3]);
}

// returns record count, or -1 malformed / -3 max_n reached /
// -4 unsupported flavor (old version, non-Text classes, compression)
int64_t bt_hadoop_seq_index(const uint8_t* buf, int64_t len,
                            int64_t* offsets, int64_t* lengths,
                            float* labels, int64_t max_n) {
    static const char kText[] = "org.apache.hadoop.io.Text";
    if (len < 4 || std::memcmp(buf, "SEQ", 3) != 0) return -1;
    if (buf[3] < 6) return -4;
    int64_t pos = 4;
    for (int i = 0; i < 2; ++i) {
        int64_t n;
        if (hseq_vint(buf, len, &pos, &n) || n < 0 || pos + n > len) return -1;
        if (n != (int64_t)(sizeof(kText) - 1) ||
            std::memcmp(buf + pos, kText, n) != 0) return -4;
        pos += n;
    }
    if (pos + 2 > len) return -1;
    if (buf[pos] || buf[pos + 1]) return -4;  // (block-)compressed
    pos += 2;
    if (pos + 4 > len) return -1;
    int32_t nmeta = be32(buf + pos);
    pos += 4;
    for (int64_t i = 0; i < 2 * (int64_t)nmeta; ++i) {
        int64_t n;
        if (hseq_vint(buf, len, &pos, &n) || n < 0 || pos + n > len) return -1;
        pos += n;
    }
    if (pos + 16 > len) return -1;
    const uint8_t* sync = buf + pos;
    pos += 16;

    int64_t cnt = 0;
    while (pos < len) {
        if (pos + 4 > len) return -1;
        int32_t rec = be32(buf + pos);
        pos += 4;
        if (rec == -1) {  // sync escape
            if (pos + 16 > len || std::memcmp(buf + pos, sync, 16) != 0)
                return -1;
            pos += 16;
            continue;
        }
        if (cnt >= max_n) return -3;
        if (rec < 0 || pos + 4 > len) return -1;
        int32_t keylen = be32(buf + pos);
        pos += 4;
        if (keylen < 0 || keylen > rec || pos + rec > len) return -1;
        // key = serialized Text; label is the number after the last '\n'
        int64_t kp = pos, ktext;
        if (hseq_vint(buf, len, &kp, &ktext) || ktext < 0 ||
            kp + ktext > pos + keylen) return -1;
        // label = the second '\n'-separated segment when a name is
        // present, else the whole key (readLabel takes dataArr(1),
        // DataSet.scala:397-405 — the python reader does the same)
        const uint8_t* k = buf + kp;
        int64_t lb = 0, le = ktext;
        for (int64_t i = 0; i < ktext; ++i)
            if (k[i] == '\n') { lb = i + 1; break; }
        for (int64_t i = lb; i < ktext; ++i)
            if (k[i] == '\n') { le = i; break; }
        char tmp[64];
        int64_t ll = le - lb;
        if (ll <= 0 || ll > 63) return -5;  // bad label segment
        std::memcpy(tmp, k + lb, ll);
        tmp[ll] = 0;
        char* end = nullptr;
        labels[cnt] = std::strtof(tmp, &end);
        if (end != tmp + ll) return -5;  // non-numeric label: match the
        // python reader's ValueError rather than silently yielding 0.0
        // value = serialized Text right after the key bytes
        int64_t vp = pos + keylen, vtext;
        if (hseq_vint(buf, len, &vp, &vtext) || vtext < 0 ||
            vp + vtext > pos + rec) return -1;
        offsets[cnt] = vp;
        lengths[cnt] = vtext;
        pos += rec;
        ++cnt;
    }
    return cnt;
}

// --------------------------------------------------------------------- //
// Word tokenizer for the text data loader (the host-side hot loop of    //
// dataset/text.py SentenceTokenizer; the reference's OpenNLP tokenizer  //
// runs in the JVM — this is its native-runtime counterpart).            //
// Semantics mirror the python regex  [A-Za-z0-9']+|[^\sA-Za-z0-9]  over //
// an already-lowercased UTF-8 buffer: runs of word chars become one     //
// token, any other single CODE POINT (not byte) becomes one token, and  //
// ASCII whitespace separates.  Returns token count, or -1 when the      //
// output arrays are too small; byte [start, end) offsets land in        //
// starts/ends.                                                          //
// --------------------------------------------------------------------- //

static inline bool tok_word(uint8_t c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '\'';
}

// python's str \s class: ASCII whitespace + file/group/record/unit
// separators + NEL + the Unicode space code points — parity with the
// regex path requires the full set, not just ASCII (corpora are
// full of NBSP/em-spaces)
static inline bool tok_space_cp(uint32_t cp) {
    switch (cp) {
        case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
        case 0x1C: case 0x1D: case 0x1E: case 0x1F:
        case 0x85: case 0xA0: case 0x1680:
        case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
            return true;
        default:
            return cp >= 0x2000 && cp <= 0x200A;
    }
}

// decode one UTF-8 code point at s[i]; writes its value, returns its
// byte length (invalid leads decode as one replacement byte)
static inline int64_t tok_decode_cp(const uint8_t* s, int64_t len,
                                    int64_t i, uint32_t* cp) {
    uint8_t lead = s[i];
    int64_t n;
    uint32_t v;
    if (lead < 0x80) { *cp = lead; return 1; }
    else if ((lead >> 5) == 0x6) { n = 2; v = lead & 0x1F; }
    else if ((lead >> 4) == 0xE) { n = 3; v = lead & 0x0F; }
    else if ((lead >> 3) == 0x1E) { n = 4; v = lead & 0x07; }
    else { *cp = 0xFFFD; return 1; }
    if (i + n > len) { *cp = 0xFFFD; return 1; }
    for (int64_t k = 1; k < n; ++k) {
        if ((s[i + k] & 0xC0) != 0x80) { *cp = 0xFFFD; return 1; }
        v = (v << 6) | (s[i + k] & 0x3F);
    }
    *cp = v;
    return n;
}

// Single-pass variant for the python wrapper's hot path: tokens are
// written '\n'-separated into ``out`` (newline is whitespace, so it can
// never occur inside a token) — ONE buffer crossing + ONE decode/split
// on the python side instead of a per-token round trip.  Returns the
// output byte length, or -1 when ``cap`` is too small (callers size
// cap = 2 * len: worst case is one byte per token plus a separator).
int64_t bt_tokenize_join(const uint8_t* s, int64_t len,
                         uint8_t* out, int64_t cap) {
    int64_t o = 0, i = 0;
    bool first = true;
    while (i < len) {
        uint8_t c = s[i];
        int64_t start, end;
        if (tok_word(c)) {
            start = i;
            while (i < len && tok_word(s[i])) ++i;
            end = i;
        } else {
            uint32_t cp;
            int64_t cl = tok_decode_cp(s, len, i, &cp);
            if (tok_space_cp(cp)) { i += cl; continue; }
            start = i;
            end = i + cl;
            i += cl;
        }
        int64_t tok = end - start;
        if (o + tok + 1 > cap) return -1;
        if (!first) out[o++] = '\n';
        std::memcpy(out + o, s + start, tok);
        o += tok;
        first = false;
    }
    return o;
}

int64_t bt_tokenize(const uint8_t* s, int64_t len,
                    int64_t* starts, int64_t* ends, int64_t max_tokens) {
    int64_t n = 0, i = 0;
    while (i < len) {
        uint8_t c = s[i];
        if (tok_word(c)) {
            if (n >= max_tokens) return -1;
            int64_t start = i;
            while (i < len && tok_word(s[i])) ++i;
            starts[n] = start;
            ends[n] = i;
            ++n;
            continue;
        }
        uint32_t cp;
        int64_t cl = tok_decode_cp(s, len, i, &cp);
        if (tok_space_cp(cp)) { i += cl; continue; }
        if (n >= max_tokens) return -1;
        starts[n] = i;
        ends[n] = i + cl;
        ++n;
        i += cl;
    }
    return n;
}


// ---------------------------------------------------------------------
// image batcher: crop/flip/pack HWC uint8 records into an NHWC batch
// (the native hot loop behind models/utils/pipeline_bench.batch_stream;
// the reference threads this work over Engine cores in
// MTLabeledBGRImgToBatch.scala:52-80).  Work runs on a PERSISTENT
// worker pool — the batcher is called once per training batch, and
// paying thread create/join on every call would tax exactly the
// steady-state path it exists to speed up.
// ---------------------------------------------------------------------

namespace {

struct BatchJob {
    const uint8_t** recs;
    int64_t batch;
    int32_t stored_h, stored_w, crop;
    const int32_t* cy;
    const int32_t* cx;
    const uint8_t* flip;
    uint8_t* out;
};

void pack_range(const BatchJob& j, int64_t lo, int64_t hi) {
    const int64_t out_img = (int64_t)j.crop * j.crop * 3;
    for (int64_t b = lo; b < hi; ++b) {
        const uint8_t* src = j.recs[b];
        uint8_t* dst = j.out + b * out_img;
        for (int32_t r = 0; r < j.crop; ++r) {
            const uint8_t* row =
                src + ((int64_t)(j.cy[b] + r) * j.stored_w + j.cx[b]) * 3;
            uint8_t* drow = dst + (int64_t)r * j.crop * 3;
            if (!j.flip[b]) {
                std::memcpy(drow, row, (size_t)j.crop * 3);
            } else {
                for (int32_t cpx = 0; cpx < j.crop; ++cpx) {
                    const uint8_t* px = row + (int64_t)(j.crop - 1 - cpx) * 3;
                    drow[cpx * 3 + 0] = px[0];
                    drow[cpx * 3 + 1] = px[1];
                    drow[cpx * 3 + 2] = px[2];
                }
            }
        }
    }
}

class PackPool {
  public:
    explicit PackPool(int n) : n_(n), done_(0), epoch_(0),
                               shutdown_(false) {
        for (int i = 0; i < n_; ++i)
            workers_.emplace_back([this, i] { loop(i); });
    }

    ~PackPool() {
        {
            std::unique_lock<std::mutex> lk(m_);
            shutdown_ = true;
            ++epoch_;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void run(const BatchJob& job) {
        {
            std::unique_lock<std::mutex> lk(m_);
            job_ = job;
            done_ = 0;
            ++epoch_;
        }
        cv_.notify_all();
        std::unique_lock<std::mutex> lk(m_);
        cv_done_.wait(lk, [this] { return done_ == n_; });
    }

    int size() const { return n_; }

  private:
    void loop(int idx) {
        uint64_t seen = 0;
        for (;;) {
            BatchJob job;
            {
                std::unique_lock<std::mutex> lk(m_);
                cv_.wait(lk, [&] { return epoch_ != seen; });
                seen = epoch_;
                if (shutdown_) return;
                job = job_;
            }
            int64_t per = (job.batch + n_ - 1) / n_;
            int64_t lo = (int64_t)idx * per;
            int64_t hi = lo + per < job.batch ? lo + per : job.batch;
            if (lo < hi) pack_range(job, lo, hi);
            {
                std::unique_lock<std::mutex> lk(m_);
                if (++done_ == n_) cv_done_.notify_one();
            }
        }
    }

    int n_;
    std::vector<std::thread> workers_;
    std::mutex m_;
    std::condition_variable cv_, cv_done_;
    BatchJob job_;
    int done_;
    uint64_t epoch_;
    bool shutdown_;
};

std::mutex g_pool_mutex;
PackPool* g_pool = nullptr;  // leaked intentionally: workers must not be
                             // joined from atexit while a caller blocks

// fork safety: worker threads do not survive fork(); a child inheriting
// a non-null pool would publish a job no one answers and hang forever.
// prepare/parent bracket the fork with the pool lock; the child drops
// the (threadless) pool and re-creates the mutex in a known state.
void pool_atfork_prepare() { g_pool_mutex.lock(); }
void pool_atfork_parent() { g_pool_mutex.unlock(); }
void pool_atfork_child() {
    g_pool = nullptr;  // leak: its threads don't exist in this process
    new (&g_pool_mutex) std::mutex();
}

struct PoolForkGuard {
    PoolForkGuard() {
        pthread_atfork(pool_atfork_prepare, pool_atfork_parent,
                       pool_atfork_child);
    }
} g_pool_fork_guard;

}  // namespace

void bt_crop_flip_pack(const uint8_t** recs, int64_t batch,
                       int32_t stored_h, int32_t stored_w, int32_t crop,
                       const int32_t* cy, const int32_t* cx,
                       const uint8_t* flip, uint8_t* out,
                       int32_t n_threads) {
    BatchJob job{recs, batch, stored_h, stored_w, crop, cy, cx, flip, out};
    if (n_threads <= 1 || batch < 2) {
        pack_range(job, 0, batch);
        return;
    }
    std::unique_lock<std::mutex> lk(g_pool_mutex);
    // grow-only: callers with different thread counts share one pool
    // (alternating sizes must not tear the pool down on every call);
    // extra workers on a small job cost a wakeup, not a spawn
    if (g_pool == nullptr || g_pool->size() < n_threads) {
        delete g_pool;
        g_pool = new PackPool(n_threads);
    }
    g_pool->run(job);
}

}  // extern "C"
