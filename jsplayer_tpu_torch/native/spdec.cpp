// Native ScreenPressor v2/v3/v4 decoder + MSVideo1 command parser.
//
// C++ implementation of the host hot path (SURVEY.md §3 "hot loops"):
// entropy symbol decode (range coder / rANS with the Cx1..Cx7 adaptive
// context escalation) fused with frame reconstruction.  Semantics are the
// executable spec embodied by the Python oracle (jsplayer_tpu/codecs/
// rangecoder.py, rans.py, entropy.py, screenpressor.py, msvideo1.py), which
// in turn mirrors the reference decoder (ScreenPressor.hx, RangeCoder.hx,
// ANS.hx, EntroCoders.hx, MSVideo1.hx) — see those files for file:line
// parity cites.  The test suite asserts bit-exact native == oracle output.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C jsplayer_tpu/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <thread>
#include <atomic>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Range decoder (ScreenPressor v2)
// ---------------------------------------------------------------------------

constexpr uint32_t RC_TOP = 1u << 24;
constexpr uint32_t RC_BOT = 1u << 16;

// calloc-backed u32 frame buffer: fresh zero PAGES fault lazily (~20x
// cheaper than vector's explicit zero-fill of 8.3 MB at 1080p — measured
// 2.5 ms/buffer, 25% of short-GOP workloads where decoders are created
// per GOP row, e.g. gop_split).
struct ZBuf {
  uint32_t* p = nullptr;
  size_t n = 0;
  void alloc_zero(size_t count) {
    free(p);
    p = (uint32_t*)calloc(count, 4);
    n = count;
  }
  ~ZBuf() { free(p); }
  ZBuf() = default;
  ZBuf(const ZBuf&) = delete;
  ZBuf& operator=(const ZBuf&) = delete;
  uint32_t& operator[](size_t i) { return p[i]; }
  uint32_t operator[](size_t i) const { return p[i]; }
  uint32_t* data() { return p; }
  const uint32_t* data() const { return p; }
};

struct RangeDecoder {
  uint64_t range = 0, code = 0;
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;

  void begin(const uint8_t* src, size_t n, size_t pos0) {
    data = src; len = n;
    range = 0xFFFFFFFFull;
    pos = pos0;
    code = 0;
    for (int k = 1; k <= 4; k++) code = (code << 8) | byte_at(pos + k);
    pos += 5;
  }
  uint8_t byte_at(size_t p) const { return p < len ? data[p] : 0; }
  void decode(uint64_t cum, uint64_t freq) {
    if (freq == 0) freq = 1;  // corrupt stream: keep range nonzero (else the
                              // renormalization loop below never terminates)
    code -= cum * range;
    range *= freq;
    while (range < RC_TOP) {
      code = (code << 8) | byte_at(pos++);
      range <<= 8;
    }
  }
  uint64_t get_freq(uint64_t tot) {
    range /= tot;
    return code / range;
  }

  // linear-scan adaptive table decode; table[maxc] holds the total
  int decode_val(uint32_t* cnt, int maxc, uint32_t step) {
    uint64_t totfr = cnt[maxc];
    uint64_t value = get_freq(totfr);
    int c = 0;
    uint64_t cumfr = 0, cnt_c = 0;
    while (c < maxc) {
      cnt_c = cnt[c];
      if (value >= cumfr + cnt_c) cumfr += cnt_c; else break;
      c++;
    }
    if (c == maxc) {
      // corrupt stream: get_freq returned value >= totfr, so the scan ran
      // off the table.  Clamp to the last symbol (its range keeps the
      // decoder state consistent) instead of adapting cnt[maxc] (the total)
      // and returning an out-of-range symbol.
      c = maxc - 1;
      cumfr -= cnt_c;
    }
    decode(cumfr, cnt_c);
    adapt_val(cnt, maxc, c, step, (uint32_t)totfr);
    return c;
  }

  static void adapt_val(uint32_t* cnt, int maxc, int c, uint32_t step,
                        uint32_t totfr) {
    cnt[c] += step;
    totfr += step;
    if (totfr > RC_BOT) {
      totfr = 0;
      for (int i = 0; i < maxc; i++) {
        uint32_t nc = (cnt[i] >> 1) + 1;
        cnt[i] = nc;
        totfr += nc;
      }
    }
    cnt[maxc] = totfr;
  }

  // two-level 16x16 bucket table: [0..15] buckets, [16] total, [17..272] syms
  int decode_val_uni(uint32_t* cnt, uint32_t step) {
    uint64_t totfr = cnt[16];
    uint64_t value = get_freq(totfr);
    int x = 0;
    uint64_t cumfr = 0, cnt_x = 0;
    while (x < 16) {
      cnt_x = cnt[x];
      if (value >= cumfr + cnt_x) cumfr += cnt_x; else break;
      x++;
    }
    if (x == 16) {  // corrupt stream (value >= totfr): clamp to last bucket
      x = 15;
      cumfr -= cnt_x;
    }
    int c = x * 16;
    uint64_t cnt_c = 0;
    while (c < 256) {
      cnt_c = cnt[c + 17];
      if (value >= cumfr + cnt_c) cumfr += cnt_c; else break;
      c++;
    }
    if (c == 256) {  // corrupt stream: clamp to last symbol, keep in-bounds
      c = 255;
      cumfr -= cnt_c;
    }
    decode(cumfr, cnt_c);
    cnt[c + 17] += step;
    cnt[x] += step;
    uint32_t tf = (uint32_t)totfr + step;
    if (tf > RC_BOT) {
      tf = 0;
      for (int i = 17; i < 256 + 17; i++) {
        uint32_t nc = (cnt[i] >> 1) + 1;
        cnt[i] = nc;
        tf += nc;
      }
      for (int i = 0; i < 16; i++) {
        uint32_t s = 0;
        for (int j = 0; j < 16; j++) s += cnt[(i << 4) + 17 + j];
        cnt[i] = s;
      }
    }
    cnt[16] = tf;
    return c;
  }
};

// ---------------------------------------------------------------------------
// rANS decoder state
// ---------------------------------------------------------------------------

constexpr int RANS_B = 131072;
constexpr uint32_t PROB_SCALE = 4096;
constexpr uint32_t RANS_BYTE_L = 1u << 23;

struct Rans {
  uint32_t r = 0;
  const uint8_t* data = nullptr;
  size_t len = 0, pos = 0;

  uint8_t byte_at(size_t p) const { return p < len ? data[p] : 0; }
  void init(const uint8_t* src, size_t n, size_t i) {
    data = src; len = n;
    r = (uint32_t)byte_at(i) | ((uint32_t)byte_at(i + 1) << 8)
      | ((uint32_t)byte_at(i + 2) << 16) | ((uint32_t)byte_at(i + 3) << 24);
    pos = i + 4;
  }
  void reinit() { init(data, len, pos); }
  uint32_t dec_get() const { return r & 4095; }
  void dec_advance(uint32_t start, uint32_t freq) {
    uint32_t x = freq * (r >> 12) + (r & 4095) - start;
    if (x == 0) x = RANS_BYTE_L;  // corrupt stream: x<<8|0 would spin forever
    while (x < RANS_BYTE_L) x = (x << 8) | byte_at(pos++);
    r = x;
  }
  uint8_t raw() { return byte_at(pos++); }
};

// ---------------------------------------------------------------------------
// FixedSizeRansCtx
// ---------------------------------------------------------------------------

constexpr int STEP_FX = 16;
// dec_table bucket width, 32 buckets as in the reference (ANS.hx decTable).
// The table is fully rebuilt on every renew/rescale and decode() scans
// forward from the bucket's first symbol, so finer buckets would stay
// bit-exact — but a 16x finer table measured net-SLOWER on entropy-bound
// content (more L1 pressure from 256B/context tables + 16x costlier
// rescale refills outweigh the shorter scans; BENCH_NOTES round 2).
constexpr int DSHIFT = 7;
constexpr int DVAL = 1 << DSHIFT;

struct FixedCtx {
  int nsym = 0;
  std::vector<uint16_t> freq, cumfreq, cnts;
  uint32_t cntsum = 0;
  uint8_t dec_table[PROB_SCALE / DVAL] = {0};

  void init(int n) {
    nsym = n;
    freq.assign(n, 0);
    cumfreq.assign(n, 0);
    cnts.assign(n, 0);
    cntsum = 0;
  }
  void fill_dec(uint32_t cf, uint32_t fr, int i) {
    // out-of-range writes dropped (JS Uint8Array semantics)
    int k0 = (int)((cf + DVAL - 1) >> DSHIFT);
    int k1 = (int)(((cf + fr - 1) >> DSHIFT) + 1);
    if (k1 > (int)(PROB_SCALE / DVAL)) k1 = PROB_SCALE / DVAL;
    for (int k = k0; k < k1; k++) dec_table[k] = (uint8_t)i;
  }
  void renew() {
    uint32_t fr = PROB_SCALE / nsym;
    uint32_t c0 = fr - (fr >> 1);
    cntsum = c0 * nsym;
    uint32_t cf = 0;
    for (int i = 0; i < nsym; i++) {
      freq[i] = (uint16_t)fr;
      cumfreq[i] = (uint16_t)cf;
      cnts[i] = (uint16_t)c0;
      fill_dec(cf, fr, i);
      cf += fr;
    }
  }
  void incr(int c) {
    cnts[c] += STEP_FX;
    cntsum += STEP_FX;
    if (cntsum + STEP_FX > PROB_SCALE) {
      cntsum = 0;
      uint32_t cf = 0;
      for (int j = 0; j < nsym; j++) {
        uint32_t fr = cnts[j];
        freq[j] = (uint16_t)fr;
        cumfreq[j] = (uint16_t)cf;
        fill_dec(cf, fr, j);
        cf += fr;
        cnts[j] -= fr >> 1;
        cntsum += cnts[j];
      }
    }
  }
  int decode(uint32_t sf, uint32_t* ofreq, uint32_t* ocum) {
    int c0 = dec_table[sf >> DSHIFT];
    for (int j = c0; j < nsym - 1; j++) {
      if (cumfreq[j + 1] > sf) {
        *ofreq = freq[j]; *ocum = cumfreq[j];
        incr(j);
        return j;
      }
    }
    *ofreq = freq[nsym - 1]; *ocum = cumfreq[nsym - 1];
    incr(nsym - 1);
    return nsym - 1;
  }
  // encode side: interval for a known symbol, identical adaptation
  void encode(int c, uint32_t* ofreq, uint32_t* ocum) {
    *ofreq = freq[c];
    *ocum = cumfreq[c];
    incr(c);
  }
};

// ---------------------------------------------------------------------------
// Adaptive contexts Cx1..Cx7 (clr path)
// ---------------------------------------------------------------------------

constexpr int SC_F0 = 50;
constexpr int CX6_STEP = 25;

struct SmallCtx {  // Cx4 (S=4) / Cx5 (S=16)
  int S = 0, d = 0, maxpos = 0;
  int32_t totfr_tmp = 0;  // mirrors static SmallContext.totFr
  uint8_t symbols[16];
  uint16_t freqs[16];
  uint32_t cntsum = 0;  // Cx5 only

  void create(const uint8_t* syms, int n, int c) {
    d = n;
    uint8_t ss[16];
    memcpy(ss, syms, n);
    // insertion sort
    for (int i = 1; i < n; i++) {
      int j = i;
      while (j > 0 && ss[j - 1] > ss[j]) { std::swap(ss[j - 1], ss[j]); j--; }
    }
    for (int i = 0; i < n; i++) {
      symbols[i] = ss[i];
      if (ss[i] == c) { freqs[i] = 2 * SC_F0; maxpos = i; }
      else freqs[i] = SC_F0;
    }
  }
  void rescale() {
    int s = 256 - d;
    for (int i = 0; i < d; i++) {
      freqs[i] -= freqs[i] >> 1;
      s += freqs[i];
    }
    totfr_tmp = s;
  }
  bool add_symb(int pos, int c) {
    if (d == S) return false;
    for (int i = d - 1; i >= pos; i--) {
      symbols[i + 1] = symbols[i];
      freqs[i + 1] = freqs[i];
    }
    symbols[pos] = (uint8_t)c;
    freqs[pos] = SC_F0;
    d++;
    if (maxpos >= pos) maxpos++;
    totfr_tmp += SC_F0;
    if (totfr_tmp + SC_F0 > (int)PROB_SCALE) rescale();
    return true;
  }
  void met_update(int pos) {
    freqs[pos] += SC_F0;
    totfr_tmp += SC_F0;
    if (pos != maxpos && freqs[pos] > freqs[maxpos]) maxpos = pos;
    if (totfr_tmp + SC_F0 > (int)PROB_SCALE) rescale();
  }
  // returns c; sets ofreq/ocum; *fit=false when table full (upgrade needed)
  int decode_sc(uint32_t sf, int totfr0, uint32_t* ofreq, uint32_t* ocum,
                bool* fit) {
    totfr_tmp = totfr0;
    int shift = 0;
    int tot = totfr0;
    if (tot <= 0) tot = 1;  // corrupt state: 0<<1 would spin forever
    while (tot <= (int)PROB_SCALE / 2) { tot <<= 1; shift++; }
    sf >>= shift;
    int bonus = (int)(PROB_SCALE - tot) >> shift;
    uint16_t max_freq = freqs[maxpos];
    freqs[maxpos] += bonus;
    int cum = 0, last_symb = 0, pos = 0;
    while (pos < d) {
      int s = symbols[pos];
      int start_fr = cum + s - last_symb;
      if ((int)sf < start_fr) {
        int c = (int)sf - cum + last_symb;
        cum = (int)sf;
        *ofreq = 1u << shift; *ocum = (uint32_t)cum << shift;
        freqs[maxpos] = max_freq;
        *fit = add_symb(pos, c);
        return c;
      }
      int fr = freqs[pos];
      if (start_fr + fr > (int)sf) {
        int c = s;
        cum += c - last_symb;
        *ofreq = (uint32_t)fr << shift; *ocum = (uint32_t)cum << shift;
        freqs[maxpos] = max_freq;
        met_update(pos);
        *fit = true;
        return c;
      }
      cum += s - last_symb + fr;
      last_symb = s + 1;
      pos++;
    }
    freqs[maxpos] = max_freq;
    int c = last_symb + (int)sf - cum;
    *ofreq = 1u << shift; *ocum = (uint32_t)sf << shift;
    *fit = add_symb(pos, c);
    return c;
  }
  // interval for known symbol c — same walk & mutations as decode_sc
  void encode_sc(int c, int totfr0, uint32_t* ofreq, uint32_t* ocum,
                 bool* fit) {
    totfr_tmp = totfr0;
    int shift = 0;
    int tot = totfr0;
    if (tot <= 0) tot = 1;  // corrupt state: 0<<1 would spin forever
    while (tot <= (int)PROB_SCALE / 2) { tot <<= 1; shift++; }
    int bonus = (int)(PROB_SCALE - tot) >> shift;
    uint16_t max_freq = freqs[maxpos];
    freqs[maxpos] += bonus;
    int cum = 0, last_symb = 0, pos = 0;
    while (pos < d) {
      int s = symbols[pos];
      if (c < s) {
        int sf = cum + (c - last_symb);
        *ofreq = 1u << shift; *ocum = (uint32_t)sf << shift;
        freqs[maxpos] = max_freq;
        *fit = add_symb(pos, c);
        return;
      }
      int fr = freqs[pos];
      if (c == s) {
        cum += c - last_symb;
        *ofreq = (uint32_t)fr << shift; *ocum = (uint32_t)cum << shift;
        freqs[maxpos] = max_freq;
        met_update(pos);
        *fit = true;
        return;
      }
      cum += s - last_symb + fr;
      last_symb = s + 1;
      pos++;
    }
    freqs[maxpos] = max_freq;
    int sf = cum + (c - last_symb);
    *ofreq = 1u << shift; *ocum = (uint32_t)sf << shift;
    *fit = add_symb(pos, c);
  }
  int totfr0_cx4() const {
    return freqs[0] + freqs[1] + freqs[2] + freqs[3] + 256 - d;
  }
  void calc_sum_cx5() {
    int t = 256 - d;
    for (int i = 0; i < d; i++) t += freqs[i];
    cntsum = (uint32_t)t;
  }
};

struct Cx6 {
  int S = 0, d = 0, fshift = 0, f0 = 32;
  std::vector<uint8_t> symbols;
  std::vector<uint16_t> freq, cumfreq, cnts;
  uint32_t cntsum = 0;

  void init(int s) {
    S = s;
    symbols.assign(s, 0);
    freq.assign(s, 0);
    cumfreq.assign(s, 0);
    cnts.assign(s, 0);
    cntsum = 0;
  }
  void calc_sum() {
    int shft = fshift > 0 ? fshift - 1 : 0;
    uint32_t sum = (uint32_t)(256 - d) << shft;
    for (int i = 0; i < S; i++) sum += cnts[i];
    cntsum = sum;
  }
  void rescale_dec() {
    int sh = fshift > 0 ? fshift - 1 : 0;
    uint16_t c0 = (uint16_t)(1 << sh);
    uint16_t tc[256];
    for (int i = 0; i < 256; i++) tc[i] = c0;
    for (int i = 0; i < d; i++) tc[symbols[i]] = cnts[i];
    uint16_t tf[256], tcf[256];
    uint32_t cum = 0;
    for (int i = 0; i < 256; i++) {
      tf[i] = tc[i];
      tcf[i] = (uint16_t)cum;
      cum += tc[i];
    }
    if (fshift > 0) fshift--;
    int shft = fshift > 0 ? fshift - 1 : 0;
    uint32_t s = (uint32_t)(256 - d) << shft;
    for (int i = 0; i < d; i++) {
      cnts[i] -= cnts[i] >> 1;
      s += cnts[i];
      int idx = symbols[i];
      freq[i] = tf[idx];
      cumfreq[i] = tcf[idx];
    }
    cntsum = s;
  }
  void incr(int pos) {
    int step = CX6_STEP << fshift;
    cnts[pos] += step;
    cntsum += step;
    if (pos > 0 && cnts[pos] > cnts[pos - 1]) {
      std::swap(cnts[pos], cnts[pos - 1]);
      std::swap(freq[pos], freq[pos - 1]);
      std::swap(cumfreq[pos], cumfreq[pos - 1]);
      std::swap(symbols[pos], symbols[pos - 1]);
    }
    if (cntsum + step > PROB_SCALE) rescale_dec();
  }
  int add_dec(int c, uint32_t fr, uint32_t cf) {
    if (d >= 40 || d >= S) return -1;
    int pos = d;
    symbols[pos] = (uint8_t)c;
    freq[pos] = (uint16_t)fr;
    cumfreq[pos] = (uint16_t)cf;
    cnts[pos] = (uint16_t)(fr - (fr >> 1));
    d++;
    return pos;
  }
  void grow() {
    int S2 = S * 2;
    symbols.resize(S2, 0);
    freq.resize(S2, 0);
    cumfreq.resize(S2, 0);
    cnts.resize(S2, 0);
    S = S2;
  }
  // returns c; *handled=false => upgrade to Cx7 with the set interval
  int decode(uint32_t sf, uint32_t* ofreq, uint32_t* ocum, bool* handled) {
#if defined(__AVX2__)
    // Hot path: the known-symbol hit.  Symbol intervals are disjoint, so
    // at most one i satisfies cumfreq[i] <= sf < cumfreq[i]+freq[i]; a
    // 16-wide epi16 compare finds it without the scalar loop's carried
    // lower-neighbor bookkeeping (values < 8192, so signed compares are
    // exact).  Lanes >= d hold stale table entries — candidates are
    // re-checked scalar before use.  Misses (new-symbol escapes) fall
    // through to the exact reference scan below.
    {
      const __m256i vsf = _mm256_set1_epi16((short)sf);
      for (int i = 0; i < d; i += 16) {
        __m256i cf = _mm256_loadu_si256((const __m256i*)&cumfreq[i]);
        __m256i fr = _mm256_loadu_si256((const __m256i*)&freq[i]);
        __m256i le = _mm256_cmpgt_epi16(cf, vsf);  // cf > sf (to negate)
        __m256i gt = _mm256_cmpgt_epi16(_mm256_add_epi16(cf, fr), vsf);
        uint32_t m = (uint32_t)_mm256_movemask_epi8(
            _mm256_andnot_si256(le, gt));
        while (m) {
          int idx = i + (int)(__builtin_ctz(m) >> 1);
          if (idx < d && cumfreq[idx] <= sf
              && cumfreq[idx] + (uint32_t)freq[idx] > sf) {
            *ofreq = freq[idx]; *ocum = cumfreq[idx];
            int c = symbols[idx];
            incr(idx);
            *handled = true;
            return c;
          }
          m &= m - 1;
          m &= m - 1;  // clear both bytes of the lane
        }
      }
    }
#endif
    uint32_t lfreq = 0, lcum = 0;
    int lower_sym = 0;
    for (int i = 0; i < d; i++) {
      uint32_t cf = cumfreq[i];
      if (cf <= sf) {
        uint32_t fr = freq[i];
        if (cf + fr > sf) {
          *ofreq = fr; *ocum = cf;
          int c = symbols[i];
          incr(i);
          *handled = true;
          return c;
        }
        if (cf >= lcum) { lfreq = fr; lcum = cf; lower_sym = symbols[i]; }
      }
    }
    uint32_t fr_freq = 1u << fshift;
    int c;
    uint32_t fr_cum;
    if (lfreq > 0) {
      uint32_t cum = lcum + lfreq;
      int x = (int)((sf - cum) >> fshift);
      c = x + lower_sym + 1;
      fr_cum = lcum + lfreq + ((uint32_t)x << fshift);
    } else {
      c = (int)(sf >> fshift);
      fr_cum = (uint32_t)c << fshift;
    }
    *ofreq = fr_freq; *ocum = fr_cum;
    int p = add_dec(c, fr_freq, fr_cum);
    if (p < 0) {
      if (S == 64) { *handled = false; return c; }
      grow();
      p = add_dec(c, fr_freq, fr_cum);
    }
    incr(p);
    *handled = true;
    return c;
  }
  // interval for known symbol c — value-monotone cumfreq layout gives the
  // same lower-neighbor choice as decode
  int encode(int c, uint32_t* ofreq, uint32_t* ocum, bool* handled) {
    uint32_t lfreq = 0, lcum = 0;
    int lower_sym = 0;
    for (int i = 0; i < d; i++) {
      if (symbols[i] == c) {
        *ofreq = freq[i]; *ocum = cumfreq[i];
        incr(i);
        *handled = true;
        return c;
      }
      if (symbols[i] < c) {
        uint32_t cf = cumfreq[i];
        if (cf >= lcum) { lfreq = freq[i]; lcum = cf; lower_sym = symbols[i]; }
      }
    }
    uint32_t fr_freq = 1u << fshift;
    uint32_t fr_cum;
    if (lfreq > 0)
      fr_cum = lcum + lfreq + ((uint32_t)(c - lower_sym - 1) << fshift);
    else
      fr_cum = (uint32_t)c << fshift;
    *ofreq = fr_freq; *ocum = fr_cum;
    int p = add_dec(c, fr_freq, fr_cum);
    if (p < 0) {
      if (S == 64) { *handled = false; return c; }
      grow();
      p = add_dec(c, fr_freq, fr_cum);
    }
    incr(p);
    *handled = true;
    return c;
  }
  void create_from5(const SmallCtx& c5, int c) {
    init(32);
    int oldd = c5.d;
    int totfr = 256 - oldd;
    for (int i = 0; i < oldd; i++) totfr += c5.freqs[i];
    int shift = 0, tot = totfr;
    if (tot <= 0) tot = 1;  // corrupt state: 0<<1 would spin forever
    while (tot <= (int)PROB_SCALE / 2) { tot <<= 1; shift++; }
    int cum = 0, last_symb = 0;
    for (int pos = 0; pos < oldd; pos++) {
      int s = c5.symbols[pos];
      cum += s - last_symb;
      int cfr = c5.freqs[pos];
      uint32_t fr = (uint32_t)cfr << shift;
      freq[pos] = (uint16_t)fr;
      cumfreq[pos] = (uint16_t)((uint32_t)cum << shift);
      cnts[pos] = (uint16_t)(fr - (fr >> 1));
      symbols[pos] = (uint8_t)s;
      cum += cfr;
      last_symb = s + 1;
    }
    fshift = shift;
    uint32_t fr_freq = 1u << shift;
    uint32_t fr_cum = 0;
    if (c > 0) {
      int lower_sym = -1;
      uint32_t lfreq = 0, lcum = 0;
      for (int i = 0; i < oldd; i++) {
        int s = symbols[i];
        if (s > lower_sym && s < c) {
          lower_sym = s;
          lfreq = freq[i];
          lcum = cumfreq[i];
        }
      }
      if (lfreq > 0) fr_cum = lcum + lfreq + ((uint32_t)(c - lower_sym - 1) << shift);
      else fr_cum = (uint32_t)c << shift;
    }
    freq[oldd] = (uint16_t)fr_freq;
    cumfreq[oldd] = (uint16_t)fr_cum;
    cnts[oldd] = (uint16_t)(fr_freq - (fr_freq >> 1));
    symbols[oldd] = (uint8_t)c;
    d = oldd + 1;
    int step = CX6_STEP << fshift;
    cnts[oldd] += step;
    cntsum += step;
    if (cntsum + step > PROB_SCALE) rescale_dec();
    calc_sum();
    for (int i = 0; i < d - 1; i++)
      for (int j = i + 1; j < d; j++)
        if (freq[j] > freq[i]) {
          std::swap(freq[i], freq[j]);
          std::swap(cumfreq[i], cumfreq[j]);
          std::swap(cnts[i], cnts[j]);
          std::swap(symbols[i], symbols[j]);
        }
  }
  void create_from2(const uint8_t* syms, int n, int c) {
    init(n <= 32 ? 32 : 64);
    int oldd = n;
    int totfr = 256 - oldd + oldd * f0 + f0;
    int shift = 0, tot = totfr;
    if (tot <= 0) tot = 1;  // corrupt state: 0<<1 would spin forever
    while (tot <= (int)PROB_SCALE / 2) { tot <<= 1; shift++; }
    uint8_t ss[256];
    memcpy(ss, syms, n);
    for (int i = 1; i < n; i++) {
      int j = i;
      while (j > 0 && ss[j - 1] > ss[j]) { std::swap(ss[j - 1], ss[j]); j--; }
    }
    int cum = 0, last_symb = 0, new_symb_pos = 0;
    for (int pos = 0; pos < oldd; pos++) {
      int s = ss[pos];
      cum += s - last_symb;
      int cfr;
      if (s == c) { new_symb_pos = pos; cfr = f0 * 2; }
      else cfr = f0;
      uint32_t fr = (uint32_t)cfr << shift;
      freq[pos] = (uint16_t)fr;
      cumfreq[pos] = (uint16_t)((uint32_t)cum << shift);
      symbols[pos] = (uint8_t)s;
      cnts[pos] = (uint16_t)(fr - (fr >> 1));
      cum += cfr;
      last_symb = s + 1;
    }
    d = oldd;
    fshift = shift;
    calc_sum();
    if (new_symb_pos > 0) {
      std::swap(freq[0], freq[new_symb_pos]);
      std::swap(cumfreq[0], cumfreq[new_symb_pos]);
      std::swap(cnts[0], cnts[new_symb_pos]);
      std::swap(symbols[0], symbols[new_symb_pos]);
    }
  }
};

struct Cx7 : FixedCtx {
  void create_from3(const uint8_t* syms, int n, int c) {
    init(256);
    for (int i = 0; i < 256; i++) { freq[i] = 1; cnts[i] = 1; }
    int f0 = (int)(PROB_SCALE - (256 - n)) / (n + 1);
    int c0 = f0 - (f0 >> 1);
    for (int i = 0; i < n; i++) {
      int s = syms[i];
      freq[s] = (uint16_t)f0;
      cnts[s] = (uint16_t)c0;
    }
    freq[c] += f0;
    cnts[c] += STEP_FX;
    cntsum = 0;
    uint32_t cf = 0;
    for (int i = 0; i < 256; i++) {
      cntsum += cnts[i];
      cumfreq[i] = (uint16_t)cf;
      uint32_t fr = freq[i];
      fill_dec(cf, fr, i);
      cf += fr;
    }
  }
  void create_from6(const Cx6& c6) {
    init(256);
    cntsum = c6.cntsum;
    for (int i = 0; i < c6.S; i++)
      if (c6.cnts[i] > 0) {
        int x = c6.symbols[i];
        freq[x] = c6.freq[i];
        cumfreq[x] = c6.cumfreq[i];
        cnts[x] = c6.cnts[i];
      }
    uint32_t funmet = 1u << c6.fshift;
    uint16_t cnt_unmet = (uint16_t)(funmet - (funmet >> 1));
    uint32_t cum = 0;
    for (int i = 0; i < 256; i++) {
      uint32_t fr;
      if (freq[i] > 0) fr = freq[i];
      else {
        freq[i] = (uint16_t)funmet;
        cumfreq[i] = (uint16_t)cum;
        cnts[i] = cnt_unmet;
        fr = funmet;
      }
      fill_dec(cum, fr, i);
      cum += fr;
    }
  }
};

enum CtxKind : uint8_t { K_NONE = 0, K1, K2, K3, K4, K5, K6, K7 };

struct Context {
  CtxKind kind = K_NONE;
  uint8_t list_d = 0;
  uint16_t list_cap = 0;
  std::vector<uint8_t> list;  // Cx1/2/3 symbol list
  SmallCtx* sc = nullptr;     // Cx4/5
  Cx6* c6 = nullptr;
  Cx7* c7 = nullptr;
  int f0_cx6 = 32;

  void renew() {
    kind = K_NONE;
    list_d = 0;
    delete sc; sc = nullptr;
    delete c6; c6 = nullptr;
    delete c7; c7 = nullptr;
  }
  ~Context() { renew(); }

  int find_or_add(int c) {  // 0 found, 1 added, 2 noroom
    for (int i = 0; i < list_d; i++)
      if (list[i] == c) return 0;
    if (list_d < list_cap) {
      list[list_d++] = (uint8_t)c;
      return 1;
    }
    return 2;
  }

  // decode-or-escape: returns true + sets c/ofreq/ocum when a model handled
  bool decode(uint32_t sf, int* c, uint32_t* ofreq, uint32_t* ocum) {
    bool ok;
    switch (kind) {
      case K6: {
        *c = c6->decode(sf, ofreq, ocum, &ok);
        if (!ok) {
          Cx7* n = new Cx7();
          n->create_from6(*c6);
          delete c6; c6 = nullptr;
          c7 = n;
          kind = K7;
        }
        return true;
      }
      case K7: {
        uint32_t f, cf;
        *c = c7->decode(sf, &f, &cf);
        *ofreq = f; *ocum = cf;
        return true;
      }
      case K4: {
        *c = sc->decode_sc(sf, sc->totfr0_cx4(), ofreq, ocum, &ok);
        if (!ok) upgrade4to5(*c);
        return true;
      }
      case K5: {
        *c = sc->decode_sc(sf, (int)sc->cntsum, ofreq, ocum, &ok);
        sc->cntsum = (uint32_t)sc->totfr_tmp;
        if (!ok) upgrade5to6(*c);
        return true;
      }
      default:
        return false;
    }
  }

  void upgrade4to5(int c) {
    // Cx5.fromCx4 (sorted merge insert)
    SmallCtx* n = new SmallCtx();
    n->S = 16;
    int i = 0, dd = sc->d, j = 0, totfr = 0;
    while (i < dd && sc->symbols[i] < c) {
      n->symbols[i] = sc->symbols[i];
      n->freqs[i] = sc->freqs[i];
      totfr += n->freqs[i];
      i++;
    }
    j = i;
    n->symbols[j] = (uint8_t)c;
    n->freqs[j] = SC_F0;
    totfr += SC_F0;
    j++;
    while (i < dd) {
      n->symbols[j] = sc->symbols[i];
      n->freqs[j] = sc->freqs[i];
      totfr += n->freqs[j];
      i++; j++;
    }
    n->d = dd + 1;
    n->maxpos = 0;
    if (totfr > (int)PROB_SCALE) {
      n->rescale();
    }
    n->calc_sum_cx5();
    delete sc;
    sc = n;
    kind = K5;
  }
  void upgrade5to6(int c) {
    Cx6* n = new Cx6();
    n->f0 = f0_cx6;
    n->create_from5(*sc, c);
    delete sc; sc = nullptr;
    c6 = n;
    kind = K6;
  }

  // encode-or-escape: true + interval when a model handled the symbol;
  // false = caller emits a raw byte then calls update(c)
  bool encode(int c, uint32_t* ofreq, uint32_t* ocum) {
    bool ok;
    switch (kind) {
      case K6: {
        c6->encode(c, ofreq, ocum, &ok);
        if (!ok) {
          Cx7* n = new Cx7();
          n->create_from6(*c6);
          delete c6; c6 = nullptr;
          c7 = n;
          kind = K7;
        }
        return true;
      }
      case K7: {
        c7->encode(c, ofreq, ocum);
        return true;
      }
      case K4: {
        sc->encode_sc(c, sc->totfr0_cx4(), ofreq, ocum, &ok);
        if (!ok) upgrade4to5(c);
        return true;
      }
      case K5: {
        sc->encode_sc(c, (int)sc->cntsum, ofreq, ocum, &ok);
        sc->cntsum = (uint32_t)sc->totfr_tmp;
        if (!ok) upgrade5to6(c);
        return true;
      }
      default:
        return false;
    }
  }

  void update(int c) {
    switch (kind) {
      case K_NONE:
        list.assign(14, 0);
        list_cap = 14;
        list[0] = (uint8_t)c;
        list_d = 1;
        kind = K1;
        break;
      case K1: {
        int r = find_or_add(c);
        if (r == 0) {
          if (list_d <= 4) {
            sc = new SmallCtx();
            sc->S = 4;
            sc->create(list.data(), list_d, c);
            kind = K4;
          } else {
            sc = new SmallCtx();
            sc->S = 16;
            sc->create(list.data(), list_d, c);
            sc->calc_sum_cx5();
            kind = K5;
          }
        } else if (r == 2) {
          std::vector<uint8_t> nl(64, 0);
          memcpy(nl.data(), list.data(), list_d);
          nl[list_d] = (uint8_t)c;
          list = std::move(nl);
          list_cap = 64;
          list_d++;
          kind = K2;
        }
        break;
      }
      case K2: {
        int r = find_or_add(c);
        if (r == 0) {
          c6 = new Cx6();
          c6->f0 = f0_cx6;
          c6->create_from2(list.data(), list_d, c);
          kind = K6;
        } else if (r == 2) {
          std::vector<uint8_t> nl(256, 0);
          memcpy(nl.data(), list.data(), list_d);
          nl[list_d] = (uint8_t)c;
          list = std::move(nl);
          list_cap = 256;
          list_d++;
          kind = K3;
        }
        break;
      }
      case K3: {
        int r = find_or_add(c);
        if (r == 0) {
          c7 = new Cx7();
          c7->create_from3(list.data(), list_d, c);
          kind = K7;
        }
        break;
      }
      default:
        break;  // unexpected (mirrors trace in reference)
    }
  }
};

// ---------------------------------------------------------------------------
// Entropy coder facades
// ---------------------------------------------------------------------------

constexpr int MSR_X = 256, MSR_Y = 256;
constexpr int CXMAX = 4096, NCXMAX = 6;
constexpr int CNTABSZ = 273;

struct EntroRC {
  RangeDecoder rc;
  std::vector<uint32_t> cntab;  // 3*4096*273
  uint32_t ptypetab[NCXMAX][7] = {};
  uint32_t ntab[NCXMAX][257] = {};
  uint32_t xxtab[257] = {};
  uint32_t ntab2[257] = {};
  uint32_t bttab[6] = {};
  uint32_t sxytab[4][17] = {};
  std::vector<uint32_t> mvtab0, mvtab1;

  EntroRC() : cntab(3 * CXMAX * CNTABSZ, 0),
              mvtab0(MSR_X * 2 + 1, 0), mvtab1(MSR_Y * 2 + 1, 0) {}

  void preinit() {
    for (int chan = 0; chan < 3; chan++)
      for (int ctx = 0; ctx < CXMAX; ctx++)
        cntab[(size_t)((chan << 12) + ctx) * CNTABSZ + 16] = 0;
  }
  void renew_i() {
    for (int chan = 0; chan < 3; chan++)
      for (int ctx = 0; ctx < CXMAX; ctx++) {
        uint32_t* p = &cntab[(size_t)(chan * CXMAX + ctx) * CNTABSZ];
        if (p[16] != 256) {
          for (int i = 0; i < 256; i++) p[i + 17] = 1;
          for (int i = 0; i < 16; i++) p[i] = 16;
          p[16] = 256;
        }
      }
    for (int n = 0; n < NCXMAX; n++) {
      for (int i = 0; i < 256; i++) ntab[n][i] = 1;
      ntab[n][256] = 256;
      for (int i = 0; i < 6; i++) ptypetab[n][i] = 1;
      ptypetab[n][6] = 6;
    }
    for (int i = 0; i < 256; i++) { xxtab[i] = 1; ntab2[i] = 1; }
    xxtab[256] = 256; ntab2[256] = 256;
    for (int i = 0; i < 5; i++) bttab[i] = 1;
    bttab[5] = 5;
    for (int c = 0; c < 4; c++) {
      for (int i = 0; i < 16; i++) sxytab[c][i] = 1;
      sxytab[c][16] = 16;
    }
    for (int i = 0; i < MSR_X * 2; i++) mvtab0[i] = 1;
    mvtab0[MSR_X * 2] = MSR_X * 2;
    for (int i = 0; i < MSR_Y * 2; i++) mvtab1[i] = 1;
    mvtab1[MSR_Y * 2] = MSR_Y * 2;
  }

  void begin(const uint8_t* src, size_t n, size_t pos0) { rc.begin(src, n, pos0); }
  int clr(int cxi) { return rc.decode_val_uni(&cntab[(size_t)cxi * CNTABSZ], 400); }
  int nrun(int pt) { return rc.decode_val(ntab[pt], 256, 400); }
  int ptype(int pt) { return rc.decode_val(ptypetab[pt], 6, 1000); }
  int xx() { return rc.decode_val(xxtab, 256, 1); }
  int bt() { return rc.decode_val(bttab, 5, 10); }
  int bn() { return rc.decode_val(ntab2, 256, 20); }
  int sxy(int n) { return rc.decode_val(sxytab[n], 16, 100); }
  int mx() { return rc.decode_val(mvtab0.data(), MSR_X * 2, 100); }
  int my() { return rc.decode_val(mvtab1.data(), MSR_Y * 2, 100); }
};

static uint32_t* g_oplog = nullptr;
static long g_oplog_cap = 0, g_oplog_n = 0;

struct EntroANS {
  Rans rans;
  int n_dec = 0;
  std::vector<Context> cntab;  // 3*4096
  FixedCtx ntab[NCXMAX], ptypetab[6], xxtab, ntab2, bttab, sxytab[4], mvtab[2];

  explicit EntroANS(int f0) : cntab(3 * CXMAX) {
    for (auto& c : cntab) c.f0_cx6 = f0;
    for (int i = 0; i < NCXMAX; i++) ntab[i].init(256);
    for (int i = 0; i < 6; i++) ptypetab[i].init(6);
    xxtab.init(256);
    ntab2.init(256);
    bttab.init(5);
    for (int i = 0; i < 4; i++) sxytab[i].init(16);
    for (int i = 0; i < 2; i++) mvtab[i].init(512);
  }
  void renew_i() {
    for (auto& c : cntab) c.renew();
    for (int i = 0; i < NCXMAX; i++) ntab[i].renew();
    for (int i = 0; i < 6; i++) ptypetab[i].renew();
    xxtab.renew();
    ntab2.renew();
    bttab.renew();
    for (int i = 0; i < 4; i++) sxytab[i].renew();
    for (int i = 0; i < 2; i++) mvtab[i].renew();
  }
  void begin(const uint8_t* src, size_t n, size_t pos0) {
    rans.init(src, n, pos0);
    n_dec = 0;
  }
  void tick() {
    if (++n_dec == RANS_B) {
      rans.reinit();
      n_dec = 0;
    }
  }
  int clr(int cxi) {
    Context& dcx = cntab[cxi];
    int c;
    uint32_t f, cf;
    int raw = 0;
    if (dcx.decode(rans.dec_get(), &c, &f, &cf)) {
      rans.dec_advance(cf, f);
    } else {
      c = rans.raw();
      dcx.update(c);
      raw = 1;
    }
    if (g_oplog && g_oplog_n < g_oplog_cap)
      g_oplog[g_oplog_n++] = ((uint32_t)cxi << 9) | ((uint32_t)raw << 8) | (uint32_t)c;
    tick();
    return c;
  }
  bool dbool() {
    uint32_t f = rans.dec_get();
    bool flag = f >= (PROB_SCALE >> 1);
    if (g_oplog && g_oplog_n < g_oplog_cap - 1) {
      g_oplog[g_oplog_n++] = 0x80000000u | (60u << 21) | (f << 9) | (flag ? 1 : 0);
      g_oplog[g_oplog_n++] = 0xC0000000u | ((flag ? 2048u : 0u) << 13) | 2048u;
    }
    rans.dec_advance(flag ? (PROB_SCALE >> 1) : 0, PROB_SCALE >> 1);
    tick();
    return flag;
  }
  int fdec(FixedCtx& t, int tag) {
    uint32_t f, cf;
    uint32_t sf = rans.dec_get();
    int c = t.decode(sf, &f, &cf);
    rans.dec_advance(cf, f);
    if (g_oplog && g_oplog_n < g_oplog_cap - 1) {
      g_oplog[g_oplog_n++] = 0x80000000u | ((uint32_t)tag << 21)
                             | (sf << 9) | (uint32_t)c;
      g_oplog[g_oplog_n++] = 0xC0000000u | (cf << 13) | f;
    }
    tick();
    return c;
  }
  int nrun(int pt) { return fdec(ntab[pt], 10 + pt); }
  int ptype(int pt) { return fdec(ptypetab[pt], 20 + pt); }
  int xx() { return fdec(xxtab, 30); }
  int bt() { return fdec(bttab, 31); }
  int bn() { return fdec(ntab2, 32); }
  int sxy(int n) { return fdec(sxytab[n], 40 + n); }
  int mx() { return fdec(mvtab[0], 50); }
  int my() { return fdec(mvtab[1], 51); }
};

// ---------------------------------------------------------------------------
// ScreenPressor decoder
// ---------------------------------------------------------------------------

struct SpDecoder {
  int X, Y, bpp, sc_cxshift;
  int nbx, nby;
  std::vector<int32_t> bts;
  // ping-pong frame buffers: buf[cur] = latest decoded frame; the other one
  // holds the frame before it.  touched[] marks blocks painted by the latest
  // frame so only stale blocks need copying (sparse-copy optimization over
  // the reference's per-block copy loops, ScreenPressor.hx:376-380,469-473).
  ZBuf buf0, buf1;
  std::vector<uint8_t> touched;
  std::vector<uint8_t> skipped_pre;  // per-frame pre-copy skip set
  // persistent capture scratch for the transport wrappers (bc/kmv/sparse):
  // a fresh 228 KB/frame of zeroed vectors measured ~5% of the terminal-
  // corpus host stage (round 4); decompress_p zeroes cap_mv/cap_rect
  // itself, so reuse needs no clearing here
  std::vector<int32_t> scr_cb, scr_cm, scr_cr;
  void ensure_scratch() {
    size_t nb = (size_t)nbx * nby;
    if (scr_cb.size() != nb) {
      scr_cb.resize(nb);
      scr_cm.resize(nb * 2);
      scr_cr.resize(nb * 4);
    }
  }
  int cur = 0;
  bool has_prev = false, decoded_i = false, has_flat = false;
  uint32_t last_flat = 0;
  EntroRC* rc = nullptr;
  EntroANS* ans = nullptr;
  int cx = 0, cx1 = 0;
  int insignificant_blocks = 0;

  SpDecoder(int w, int h, int bits) : X(w), Y(h), bpp(bits) {
    sc_cxshift = bits == 16 ? 0 : 2;
    nbx = (w + 15) / 16;
    nby = (h + 15) / 16;
    bts.assign((size_t)nbx * nby, 0);
    buf0.alloc_zero((size_t)w * h);
    buf1.alloc_zero((size_t)w * h);
    touched.assign((size_t)nbx * nby, 1);
  }
  uint32_t* latest() { return cur == 0 ? buf0.data() : buf1.data(); }
  uint32_t* older() { return cur == 0 ? buf1.data() : buf0.data(); }
  ~SpDecoder() { delete rc; delete ans; }

  void preinit(int insign_lines) {
    insignificant_blocks = nbx * ((insign_lines + 15) / 16);
  }

  bool init_entro(int version) {
    if (version == 2) rc = new EntroRC();
    else if (version == 3) { ans = new EntroANS(64); sc_cxshift = 2; }
    else if (version == 4) { ans = new EntroANS(32); sc_cxshift = 2; }
    else return false;
    if (rc) rc->preinit();
    return true;
  }
  void renew_i_tables() {
    has_prev = false;
    if (has_flat) return;
    if (rc) rc->renew_i();
    if (ans) ans->renew_i();
  }
  bool diff16() const { return rc != nullptr; }
  void cx_consts(int* mask, int* s1, int* s) const {
    if (bpp == 16 && diff16()) { *mask = 0xFF00; *s1 = 2; *s = 16; }
    else { *mask = 0xFC00; *s1 = 4; *s = 18; }
  }

  int dec_clr(int cxi) { return rc ? rc->clr(cxi) : ans->clr(cxi); }
  int dec_n(int pt) { return rc ? rc->nrun(pt) : ans->nrun(pt); }
  int dec_p(int pt) { return rc ? rc->ptype(pt) : ans->ptype(pt); }
  int dec_x() { return rc ? rc->xx() : ans->xx(); }
  int dec_bt() { return rc ? rc->bt() : ans->bt(); }
  int dec_bn() { return rc ? rc->bn() : ans->bn(); }
  int dec_sxy(int n) { return rc ? rc->sxy(n) : ans->sxy(n); }
  int dec_mx() { return rc ? rc->mx() : ans->mx(); }
  int dec_my() { return rc ? rc->my() : ans->my(); }

  // cntab index guard: the RC coder at 16bpp uses SC_CXSHIFT=0
  // (ScreenPressor.hx:59), so an ADVERSARIAL 8-bit symbol can push
  // cx+cx1 past the 4096-entry channel bank (max 4032+255=4287).  The
  // reference's cntab is ONE FLAT Uint32Array of 3*4096 contexts
  // (EntroCoders.hx:55), so channel-0/1 overflow legally reads the
  // NEIGHBORING bank and decode proceeds deterministically — the fresh-
  // seed round-4 fuzz caught the earlier per-channel guard rejecting
  // streams the oracle decodes.  Only channel-2 overflow leaves the
  // array (JS undefined → NaN; the oracle raises): mirror via cx_err.
  bool cx_err = false;
  int clr_guarded(int chan) {
    int ci = chan * 4096 + cx + cx1;
    if ((unsigned)ci >= 3u * 4096u) {
      cx_err = true;
      return 0;
    }
    return dec_clr(ci);
  }

  uint32_t decode_rgb() {
    int r = clr_guarded(0);
    cx1 = (cx << 6) & 0xFC0; cx = r >> sc_cxshift;
    int g = clr_guarded(1);
    cx1 = (cx << 6) & 0xFC0; cx = g >> sc_cxshift;
    int b = clr_guarded(2);
    cx1 = (cx << 6) & 0xFC0; cx = b >> sc_cxshift;
    return ((uint32_t)b << 16) | ((uint32_t)g << 8) | (uint32_t)r;
  }

  static uint32_t grad(uint32_t L, uint32_t U1, uint32_t U0) {
    uint32_t r = ((L & 0xFF) + (U1 & 0xFF) - (U0 & 0xFF)) & 0xFF;
    uint32_t g = (((L >> 8) & 0xFF) + ((U1 >> 8) & 0xFF) - ((U0 >> 8) & 0xFF)) & 0xFF;
    uint32_t b = (((L >> 16) & 0xFF) + ((U1 >> 16) & 0xFF) - ((U0 >> 16) & 0xFF)) & 0xFF;
    return (b << 16) | (g << 8) | r;
  }

  // returns 0 ok, -1 error; dst size X*Y
  int decompress_i(const uint8_t* src, size_t len, uint32_t* dst) {
    if (len == 0) return -1;
    int head = src[0];
    int version = (head >> 4) + 1;
    size_t end = (size_t)X * Y;
    if ((head & 0xF) == 1) {  // flat
      if (!rc && !ans && !init_entro(version)) return -1;
      renew_i_tables();
      uint32_t clr;
      if (bpp == 16) {
        uint32_t c16 = src[0] + (len > 1 ? src[1] : 0) * 256;
        uint32_t b = (c16 & 0x1F) << 3, g = ((c16 >> 5) & 0x1F) << 3,
                 r = ((c16 >> 10) & 0x1F) << 3;
        clr = (r << 16) | (g << 8) | b;
      } else {
        uint32_t b = len > 1 ? src[1] : 0, g = len > 2 ? src[2] : 0,
                 r = len > 3 ? src[3] : 0;
        clr = (r << 16) | (g << 8) | b;
      }
      uint32_t* d = older();
      for (size_t i = 0; i < end; i++) d[i] = clr;
      cur ^= 1;
      std::fill(touched.begin(), touched.end(), 1);
      if (dst) memcpy(dst, d, end * 4);
      has_prev = true;
      has_flat = true;
      last_flat = clr;
      decoded_i = true;
      return 0;
    }
    has_flat = false;
    if ((head & 0xF) != 2) return -1;
    if (!rc && !ans && !init_entro(version)) return -1;
    renew_i_tables();
    if (rc) rc->begin(src, len, 1);
    else ans->begin(src, len, 1);

    cx_err = false;
    cx = cx1 = 0;
    uint32_t* d = older();
    size_t di = 0, lasti = 0;
    uint32_t clr = 0;
    int k = 0;
    int stall = 0;  // corrupt stream: endless n==0 runs must not hang
    while (k < X + 1) {
      clr = decode_rgb();
      int n = dec_n(0);
      if (n == 0) { if (++stall > 4096) return -1; } else stall = 0;
      k += n;
      for (int i = 0; i < n && di < end; i++) d[di++] = clr;
      lasti = di ? di - 1 : 0;
    }
    int maskcx1, shiftcx1, shiftcx;
    cx_consts(&maskcx1, &shiftcx1, &shiftcx);
    long off = -(long)X - 1;
    int pt = 0;
    stall = 0;
    while (di < end) {
      size_t di0 = di;
      pt = dec_p(pt);
      if (pt == 0) clr = decode_rgb();
      int n = dec_n(pt);
      switch (pt) {
        case 0:
          for (int i = 0; i < n && di < end; i++) d[di++] = clr;
          lasti = di - 1;
          break;
        case 1:
          for (int i = 0; i < n && di < end; i++) {
            d[di] = d[lasti];
            lasti = di;
            di++;
          }
          clr = d[lasti];
          break;
        case 2:
          for (int i = 0; i < n && di < end; i++) {
            clr = d[di + off + 1];
            d[di++] = clr;
          }
          lasti = di - 1;
          break;
        case 4:
          for (int i = 0; i < n && di < end; i++) {
            clr = grad(d[lasti], d[di + off + 1], d[di + off]);
            d[di] = clr;
            lasti = di;
            di++;
          }
          break;
        case 5:
          for (int i = 0; i < n && di < end; i++) {
            clr = d[di + off];
            d[di++] = clr;
          }
          lasti = di - 1;
          break;
        default:
          break;  // ptype 3 in I-frame: no-op (reference switch has no case)
      }
      if (di == di0) { if (++stall > 4096) return -1; } else stall = 0;
      cx1 = (int)((clr & (uint32_t)maskcx1) >> shiftcx1);
      cx = (int)(clr >> shiftcx);
    }
    if (cx_err) return -1;  // adversarial cntab index (see clr_guarded)
    cur ^= 1;
    std::fill(touched.begin(), touched.end(), 1);
    if (dst) memcpy(dst, d, end * 4);
    has_prev = true;
    decoded_i = true;
    return 0;
  }

  // returns: 0 decoded-new, 1 no-change; signif out; optional capture arrays
  int decompress_p(const uint8_t* src, size_t len, uint32_t* dst, int* signif,
                   int32_t* cap_bts, int32_t* cap_mv, int32_t* cap_rect) {
    has_flat = false;
    *signif = 0;
    size_t nb = (size_t)nbx * nby;
    if (cap_bts) memset(cap_bts, 0, nb * 4);
    if (cap_mv) memset(cap_mv, 0, nb * 8);
    if (cap_rect) memset(cap_rect, 0, nb * 16);
    if (len == 0 || !decoded_i || src[0] == 0) return 1;
    cx_err = false;

    int maskcx1, shiftcx1, shiftcx;
    cx_consts(&maskcx1, &shiftcx1, &shiftcx);
    if (rc) rc->begin(src, len, 1);
    else ans->begin(src, len, 1);

    int t = dec_x();
    int xx1 = (dec_x() << 8) + t;
    t = dec_x();
    int xx2 = (dec_x() << 8) + t;

    std::fill(bts.begin(), bts.end(), 0);
    int x = xx1;
    while (x <= xx2) {
      int block_type = dec_bt();
      int n = dec_bn();
      for (int i = 0; i < n && x < (int)nb; i++) bts[x++] = block_type;
      // malformed stream guards: zero-length run, or a corrupt xx2 beyond
      // the block count (x can no longer advance — the reference's elastic
      // JS array just grows there; we stop instead)
      if (n == 0 || x >= (int)nb) break;
    }

    for (size_t i = insignificant_blocks; i < nb; i++)
      if (bts[i] > 0) { *signif = 1; break; }
    if (cap_bts)
      for (size_t i = 0; i < nb; i++) cap_bts[i] = bts[i];

    size_t end = (size_t)X * Y;
    uint32_t* d = older();       // becomes the new frame
    uint32_t* pv = latest();     // previous frame
    // Sparse pre-copy: d holds t-2 content; blocks the previous frame did
    // not touch already equal t-1 there, so only touched blocks need the
    // copy.  Round-3 refinement: a touched block that THIS frame fully
    // overwrites (bts 1 full data / bts 3 full-block motion — both cover
    // the whole cropped block and read only pv or fresh pixels) can SKIP
    // the copy — on scroll chains (everything touched, everything
    // re-moved) the pre-copy was ~1/3 of the host stage.  Two hazards
    // keep blocks in the copy set:
    //   * the LAST block column: a data run whose row starts at x==0
    //     reads the previous row's RIGHTMOST pixel — a possibly
    //     later-processed block that must show t-1 (the round-1 soak
    //     bug's exact shape);
    //   * overlong-run WALKS (corrupt streams) read/write arbitrary rows
    //     below their rect — ensure_walk_safe() lazily copies all still-
    //     pending skipped blocks the first time a run escapes its rect,
    //     preserving the fuzz-pinned native==oracle semantics.
    skipped_pre.assign(nb, 0);
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++) {
        size_t bi = (size_t)by * nbx + bx;
        if (!touched[bi]) continue;
        if ((bts[bi] == 1 || bts[bi] == 3) && bx < nbx - 1) {
          skipped_pre[bi] = 1;
          continue;
        }
        int cx1b = bx * 16, cx2b = cx1b + 16 > X ? X : cx1b + 16;
        int cy1b = by * 16, cy2b = cy1b + 16 > Y ? Y : cy1b + 16;
        for (int y = cy1b; y < cy2b; y++)
          memcpy(&d[(size_t)y * X + cx1b], &pv[(size_t)y * X + cx1b],
                 (size_t)(cx2b - cx1b) * 4);
      }
    bool walk_fixed = false;
    auto ensure_walk_safe = [&](size_t bi_cur) {
      if (walk_fixed) return;
      walk_fixed = true;
      // copy t-1 into every skipped block not yet processed (raster order:
      // index > bi_cur; bi_cur itself already wrote its full-block rect)
      for (size_t j = bi_cur + 1; j < nb; j++) {
        if (!skipped_pre[j]) continue;
        int bx2_ = (int)(j % nbx), by2_ = (int)(j / nbx);
        int cx1b = bx2_ * 16, cx2b = cx1b + 16 > X ? X : cx1b + 16;
        int cy1b = by2_ * 16, cy2b = cy1b + 16 > Y ? Y : cy1b + 16;
        for (int y = cy1b; y < cy2b; y++)
          memcpy(&d[(size_t)y * X + cx1b], &pv[(size_t)y * X + cx1b],
                 (size_t)(cx2b - cx1b) * 4);
        skipped_pre[j] = 0;
      }
    };
    int stride = X;
    long off = -(long)X - 1;
    cx = cx1 = 0;
    uint32_t clr = 0;
    int lastmx = 0, lastmy = 0;
    bool bools = (ans != nullptr);
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++) {
        size_t bi = (size_t)by * nbx + bx;
        if (bts[bi] <= 0) continue;
        int x16 = bx * 16, y16 = by * 16;
        int x1 = x16, x2 = x16 + 16 > X ? X : x16 + 16;
        int y1 = y16, y2 = y16 + 16 > Y ? Y : y16 + 16;
        if ((bts[bi] - 1) & 1) {  // subrect
          x1 = dec_sxy(0) + x16;
          y1 = dec_sxy(1) + y16;
          x2 = dec_sxy(2) + x16 + 1;
          y2 = dec_sxy(3) + y16 + 1;
          // A corrupt stream can place the subrect outside the frame (edge
          // blocks are narrower than 16): frame buffers are exactly X*Y, so
          // an unchecked data-type subrect writes d[yy*stride+xx] past the
          // heap allocation.  Reject, mirroring the motion-vector check.
          if (x2 > X || y2 > Y || x1 >= x2 || y1 >= y2)
            return -1;  // invalid stream
        }
        if (cap_rect) {
          cap_rect[bi * 4 + 0] = x1;
          cap_rect[bi * 4 + 1] = y1;
          cap_rect[bi * 4 + 2] = x2;
          cap_rect[bi * 4 + 3] = y2;
        }
        if ((bts[bi] - 1) & 2) {  // motion
          int mx, my;
          if (bools && ans->dbool()) {
            mx = lastmx; my = lastmy;
          } else {
            mx = dec_mx() - MSR_X;
            my = dec_my() - MSR_Y;
          }
          lastmx = mx; lastmy = my;
          if (cap_mv) {
            cap_mv[bi * 2] = mx;
            cap_mv[bi * 2 + 1] = my;
          }
          if (y1 + my < 0 || y2 + my > Y || x1 + mx < 0 || x2 + mx > X)
            return -1;  // invalid stream
          for (int y = y1; y < y2; y++) {
            size_t i = (size_t)y * stride + x1;
            size_t j = (size_t)(y + my) * stride + (x1 + mx);
            memcpy(&d[i], &pv[j], (size_t)(x2 - x1) * 4);
          }
        } else {  // data
          int xx = x1, yy = y1;
          int pt = 0;
          // OOB predictor reads (no neighbor at frame row/col 0, or past
          // the frame end when an overlong run walks below its rect): the
          // reference's JS target reads `undefined` from the Int32Array,
          // which coerces to 0, and DROPS OOB writes.  Mirror both exactly
          // — an earlier clamp that truncated the run at the rect bottom
          // (c = n; break) was a fuzz-found divergence from the oracle:
          // the reference's while-y<y2 guard only stops the NEXT run, so
          // an overlong run keeps writing rows below the rect.
          auto at = [&](long long idx) -> uint32_t {
            return (idx >= 0 && idx < (long long)end) ? d[idx] : 0u;
          };
          int stall = 0;  // corrupt stream: endless n==0 runs must not hang
          while (yy < y2) {
            size_t i = (size_t)yy * stride + xx;
            long long di = (long long)i;
            pt = dec_p(pt);
            if (pt == 0) clr = decode_rgb();
            int n = dec_n(pt);
            if (n == 0) { if (++stall > 4096) return -1; } else stall = 0;
            for (int c = 0; c < n; c++) {
              switch (pt) {
                case 1: clr = at(di - 1); break;
                case 2: clr = at(di + off + 1); break;
                case 3: clr = i < end ? pv[i] : 0u; break;
                case 4: {
                  // the gradient reads per BYTE from dstbytes
                  // (ScreenPressor.hx:445-448): one OOB operand pixel
                  // poisons every component sum to NaN in JS, and
                  // NaN & 0xFF is 0 — so ANY OOB operand zeroes the
                  // WHOLE color, not per-operand substitution (mirrored
                  // in the oracle, codecs/screenpressor.py)
                  long long a0 = di - 1, a1 = di + off + 1, a2 = di + off;
                  bool ok = a0 >= 0 && a0 < (long long)end &&
                            a1 >= 0 && a1 < (long long)end &&
                            a2 >= 0 && a2 < (long long)end;
                  clr = ok ? grad(d[a0], d[a1], d[a2]) : 0u;
                  break;
                }
                case 5: clr = at(di + off); break;
                default: break;
              }
              if (di < (long long)end) d[di] = clr;
              xx++;
              if (xx >= x2) {
                xx = x1;
                yy++;
                // overlong run escaping its rect (corrupt streams): make
                // the skipped pre-copy blocks t-1-consistent before the
                // walk reads/writes below (see ensure_walk_safe)
                if (yy >= y2 && c + 1 < n) ensure_walk_safe(bi);
                i = (size_t)yy * stride + xx;
                di = (long long)i;
              } else {
                i++; di++;
              }
            }
            cx1 = (int)((clr & (uint32_t)maskcx1) >> shiftcx1);
            cx = (int)(clr >> shiftcx);
          }
        }
      }
    if (cx_err) return -1;  // adversarial cntab index (see clr_guarded)
    // touched feeds the NEXT frame's sparse pre-copy.  A corrupt overlong
    // run WALKS past its rect (reference semantics) and writes pixels in
    // blocks the block map never declared — deriving touched from bts
    // alone left those blocks holding t-2 on the following frame (fresh-
    // seed fuzz, round 4: v3/16bpp t+1 split).  Walks are corrupt-stream-
    // only, so the conservative full-touched frame costs nothing real.
    if (walk_fixed)
      std::fill(touched.begin(), touched.end(), 1);
    else
      for (size_t i = 0; i < nb; i++) touched[i] = bts[i] > 0 ? 1 : 0;
    cur ^= 1;
    if (dst) memcpy(dst, d, end * 4);
    return 0;
  }
};

// ---------------------------------------------------------------------------
// MSVideo1 command parser (block opcode stream → dense commands)
// ---------------------------------------------------------------------------

int msv1_parse(const uint8_t* src, size_t len, int X, int Y,
               const uint32_t* pal /*null = 16-bit*/, uint8_t* btype,
               uint8_t* sel, uint32_t* colors) {
  int nbx = X >> 2, nby = Y >> 2;
  size_t nb = (size_t)nbx * nby;
  memset(btype, 0, nb);
  memset(sel, 0, nb * 16);
  memset(colors, 0, nb * 32);
  int changes = 0;
  if (len == 0) return 0;
  size_t si = 0;
  bool is8 = pal != nullptr;
  size_t bi = 0;
  int skip = 0;
  auto rgb15 = [](uint32_t c) {
    return ((c & 0x1F) << 3) | ((c & 0x3E0) << 6) | ((c & 0x7C00) << 9);
  };
  while (bi < nb) {
    if (skip) {
      size_t take = (size_t)skip < nb - bi ? (size_t)skip : nb - bi;
      skip -= (int)take;
      bi += take;
      continue;
    }
    if (si + 2 > len) break;
    int a = src[si], b = src[si + 1];
    si += 2;
    if (is8 && a + b == 0) break;
    if ((b & 0xFC) == 0x84) {
      skip = ((b - 0x84) << 8) + a;
      continue;
    }
    if (b < 0x80) {
      if (is8) {
        if (si + 2 > len) break;
        int flags = (b << 8) + a;
        uint32_t c1 = pal[src[si]], c0 = pal[src[si + 1]];
        si += 2;
        colors[bi * 8 + 0] = c0;
        colors[bi * 8 + 1] = c1;
        for (int k = 0; k < 16; k++) sel[bi * 16 + k] = (flags >> k) & 1;
      } else {
        if (si + 4 > len) break;
        int flags = ((b << 8) + a) ^ 0xFFFF;
        uint32_t clr0 = src[si] | ((uint32_t)src[si + 1] << 8);
        uint32_t c1v = src[si + 2] | ((uint32_t)src[si + 3] << 8);
        si += 4;
        if (clr0 & 0x8000) {
          if (si + 12 > len) break;
          colors[bi * 8 + 0] = rgb15(clr0);
          colors[bi * 8 + 1] = rgb15(c1v);
          for (int k = 2; k < 8; k++) {
            colors[bi * 8 + k] = rgb15(src[si] | ((uint32_t)src[si + 1] << 8));
            si += 2;
          }
          for (int k = 0; k < 16; k++) {
            int y = k >> 2, xq = k & 3;
            sel[bi * 16 + k] =
                (uint8_t)((((y & 2) << 1) + (xq & 2)) + ((flags >> k) & 1));
          }
        } else {
          colors[bi * 8 + 0] = rgb15(clr0);
          colors[bi * 8 + 1] = rgb15(c1v);
          for (int k = 0; k < 16; k++) sel[bi * 16 + k] = (flags >> k) & 1;
        }
      }
      btype[bi] = 1;
      changes = 1;
    } else if (is8 && b >= 0x90) {
      if (si + 8 > len) break;
      int flags = ((b << 8) + a) ^ 0xFFFF;
      for (int k = 0; k < 8; k++) colors[bi * 8 + k] = pal[src[si + k]];
      si += 8;
      for (int k = 0; k < 16; k++) {
        int y = k >> 2, xq = k & 3;
        sel[bi * 16 + k] =
            (uint8_t)((((y & 2) << 1) + (xq & 2)) + ((flags >> k) & 1));
      }
      btype[bi] = 1;
      changes = 1;
    } else {
      colors[bi * 8] = is8 ? pal[a] : rgb15((uint32_t)((b << 8) + a));
      btype[bi] = 1;
      changes = 1;
    }
    bi++;
  }
  return changes;
}


// ---------------------------------------------------------------------------
// Encoders (paired with the decoders above; semantics = encode/*.py)
// ---------------------------------------------------------------------------

struct RangeEncoder {
  uint64_t low = 0;
  uint64_t range = 0xFFFFFFFFull;
  std::vector<uint8_t> out;

  void encode(uint64_t cum, uint64_t freq, uint64_t tot) {
    uint64_t r = range / tot;
    low += cum * r;
    range = r * freq;
    if (low >= (1ull << 32)) {
      low -= 1ull << 32;
      size_t i = out.size() - 1;
      while (out[i] == 0xFF) { out[i] = 0; i--; }
      out[i]++;
    }
    while (range < RC_TOP) {
      out.push_back((uint8_t)((low >> 24) & 0xFF));
      low = (low << 8) & 0xFFFFFFFFull;
      range <<= 8;
    }
  }
  void finish(std::vector<uint8_t>& dst) {
    dst.push_back(0);  // the skipped pad byte (RangeCoder.hx:29)
    dst.insert(dst.end(), out.begin(), out.end());
    for (int s = 24; s >= 0; s -= 8)
      dst.push_back((uint8_t)((low >> s) & 0xFF));
    dst.push_back(0); dst.push_back(0); dst.push_back(0);
  }
  void encode_val(uint32_t* cnt, int maxc, uint32_t step, int c) {
    uint64_t totfr = cnt[maxc];
    uint64_t cum = 0;
    for (int i = 0; i < c; i++) cum += cnt[i];
    uint64_t fr = cnt[c];
    encode(cum, fr, totfr);
    RangeDecoder::adapt_val(cnt, maxc, c, step, (uint32_t)totfr);
  }
  void encode_val_uni(uint32_t* cnt, uint32_t step, int c) {
    int x = c >> 4;
    uint64_t totfr = cnt[16];
    uint64_t cum = 0;
    for (int i = 0; i < x; i++) cum += cnt[i];
    for (int i = x * 16; i < c; i++) cum += cnt[i + 17];
    uint64_t fr = cnt[c + 17];
    encode(cum, fr, totfr);
    // adaptation identical to decode_val_uni
    cnt[c + 17] += step;
    cnt[x] += step;
    uint32_t tf = (uint32_t)totfr + step;
    if (tf > RC_BOT) {
      tf = 0;
      for (int i = 17; i < 256 + 17; i++) {
        uint32_t nc = (cnt[i] >> 1) + 1;
        cnt[i] = nc;
        tf += nc;
      }
      for (int i = 0; i < 16; i++) {
        uint32_t ssum = 0;
        for (int j = 0; j < 16; j++) ssum += cnt[(i << 4) + 17 + j];
        cnt[i] = ssum;
      }
    }
    cnt[16] = tf;
  }
};

struct EntroEncRC {
  std::vector<uint32_t> cntab;
  uint32_t ptypetab[NCXMAX][7] = {};
  uint32_t ntab[NCXMAX][257] = {};
  uint32_t xxtab[257] = {};
  uint32_t ntab2[257] = {};
  uint32_t bttab[6] = {};
  uint32_t sxytab[4][17] = {};
  std::vector<uint32_t> mvtab0, mvtab1;
  RangeEncoder* rc = nullptr;

  EntroEncRC() : cntab(3 * CXMAX * CNTABSZ, 0),
                 mvtab0(MSR_X * 2 + 1, 0), mvtab1(MSR_Y * 2 + 1, 0) {}
  ~EntroEncRC() { delete rc; }
  void renew_i() {
    for (int chan = 0; chan < 3; chan++)
      for (int ctx = 0; ctx < CXMAX; ctx++) {
        uint32_t* p = &cntab[(size_t)(chan * CXMAX + ctx) * CNTABSZ];
        if (p[16] != 256) {
          for (int i = 0; i < 256; i++) p[i + 17] = 1;
          for (int i = 0; i < 16; i++) p[i] = 16;
          p[16] = 256;
        }
      }
    for (int n = 0; n < NCXMAX; n++) {
      for (int i = 0; i < 256; i++) ntab[n][i] = 1;
      ntab[n][256] = 256;
      for (int i = 0; i < 6; i++) ptypetab[n][i] = 1;
      ptypetab[n][6] = 6;
    }
    for (int i = 0; i < 256; i++) { xxtab[i] = 1; ntab2[i] = 1; }
    xxtab[256] = 256; ntab2[256] = 256;
    for (int i = 0; i < 5; i++) bttab[i] = 1;
    bttab[5] = 5;
    for (int c = 0; c < 4; c++) {
      for (int i = 0; i < 16; i++) sxytab[c][i] = 1;
      sxytab[c][16] = 16;
    }
    for (int i = 0; i < MSR_X * 2; i++) mvtab0[i] = 1;
    mvtab0[MSR_X * 2] = MSR_X * 2;
    for (int i = 0; i < MSR_Y * 2; i++) mvtab1[i] = 1;
    mvtab1[MSR_Y * 2] = MSR_Y * 2;
  }
  void begin() { delete rc; rc = new RangeEncoder(); }
  void end(std::vector<uint8_t>& dst) { rc->finish(dst); delete rc; rc = nullptr; }
  void clr(int cxi, int c) { rc->encode_val_uni(&cntab[(size_t)cxi * CNTABSZ], 400, c); }
  void nrun(int pt, int c) { rc->encode_val(ntab[pt], 256, 400, c); }
  void ptype(int pt, int c) { rc->encode_val(ptypetab[pt], 6, 1000, c); }
  void xx(int c) { rc->encode_val(xxtab, 256, 1, c); }
  void bt(int c) { rc->encode_val(bttab, 5, 10, c); }
  void bn(int c) { rc->encode_val(ntab2, 256, 20, c); }
  void sxy(int n, int c) { rc->encode_val(sxytab[n], 16, 100, c); }
  void mx(int c) { rc->encode_val(mvtab0.data(), MSR_X * 2, 100, c); }
  void my(int c) { rc->encode_val(mvtab1.data(), MSR_Y * 2, 100, c); }
};

struct RansChunkEnc {
  struct Op { uint32_t start, freq; uint8_t raw; uint8_t is_raw; };
  std::vector<std::vector<Op>> chunks;
  int count = 0;

  RansChunkEnc() { chunks.emplace_back(); }
  void op(Op o) {
    chunks.back().push_back(o);
    if (++count == RANS_B) {
      chunks.emplace_back();
      count = 0;
    }
  }
  void put(uint32_t start, uint32_t freq) { op({start, freq, 0, 0}); }
  void put_raw(uint8_t b) { op({0, 0, b, 1}); }
  void finalize(std::vector<uint8_t>& dst) {
    for (auto& ops : chunks) {
      std::vector<uint8_t> buf;  // back-to-front
      uint64_t x = RANS_BYTE_L;
      for (auto it = ops.rbegin(); it != ops.rend(); ++it) {
        if (it->is_raw) {
          buf.push_back(it->raw);
        } else {
          uint64_t x_max = ((uint64_t)(RANS_BYTE_L >> 12) << 8) * it->freq;
          while (x >= x_max) {
            buf.push_back((uint8_t)(x & 0xFF));
            x >>= 8;
          }
          x = ((x / it->freq) << 12) + (x % it->freq) + it->start;
        }
      }
      buf.push_back((uint8_t)((x >> 24) & 0xFF));
      buf.push_back((uint8_t)((x >> 16) & 0xFF));
      buf.push_back((uint8_t)((x >> 8) & 0xFF));
      buf.push_back((uint8_t)(x & 0xFF));
      dst.insert(dst.end(), buf.rbegin(), buf.rend());
    }
  }
};

struct EntroEncANS {
  std::vector<Context> cntab;
  FixedCtx ntab[NCXMAX], ptypetab[6], xxtab, ntab2, bttab, sxytab[4], mvtab[2];
  RansChunkEnc* enc = nullptr;

  explicit EntroEncANS(int f0) : cntab(3 * CXMAX) {
    for (auto& c : cntab) c.f0_cx6 = f0;
    for (int i = 0; i < NCXMAX; i++) ntab[i].init(256);
    for (int i = 0; i < 6; i++) ptypetab[i].init(6);
    xxtab.init(256);
    ntab2.init(256);
    bttab.init(5);
    for (int i = 0; i < 4; i++) sxytab[i].init(16);
    for (int i = 0; i < 2; i++) mvtab[i].init(512);
  }
  ~EntroEncANS() { delete enc; }
  void renew_i() {
    for (auto& c : cntab) c.renew();
    for (int i = 0; i < NCXMAX; i++) ntab[i].renew();
    for (int i = 0; i < 6; i++) ptypetab[i].renew();
    xxtab.renew();
    ntab2.renew();
    bttab.renew();
    for (int i = 0; i < 4; i++) sxytab[i].renew();
    for (int i = 0; i < 2; i++) mvtab[i].renew();
  }
  void begin() { delete enc; enc = new RansChunkEnc(); }
  void end(std::vector<uint8_t>& dst) { enc->finalize(dst); delete enc; enc = nullptr; }
  bool clr(int cxi, int c) {  // false => unencodable interval (>PROB_SCALE)
    Context& dcx = cntab[cxi];
    uint32_t f, cf;
    if (dcx.encode(c, &f, &cf)) {
      if (cf + f > PROB_SCALE) return false;
      enc->put(cf, f);
    } else {
      enc->put_raw((uint8_t)c);
      dcx.update(c);
    }
    return true;
  }
  void dbool(bool flag) { enc->put(flag ? (PROB_SCALE >> 1) : 0, PROB_SCALE >> 1); }
  void fenc(FixedCtx& t, int c) {
    uint32_t f, cf;
    t.encode(c, &f, &cf);
    enc->put(cf, f);
  }
  void nrun(int pt, int c) { fenc(ntab[pt], c); }
  void ptype(int pt, int c) { fenc(ptypetab[pt], c); }
  void xx(int c) { fenc(xxtab, c); }
  void bt(int c) { fenc(bttab, c); }
  void bn(int c) { fenc(ntab2, c); }
  void sxy(int n, int c) { fenc(sxytab[n], c); }
  void mx(int c) { fenc(mvtab[0], c); }
  void my(int c) { fenc(mvtab[1], c); }
};

// ---------------------------------------------------------------------------
// ScreenPressor encoder (semantics = encode/sp_enc.py)
// ---------------------------------------------------------------------------

struct SpEncoder {
  int version, X, Y, bpp, sc_cxshift;
  int nbx, nby;
  EntroEncRC* rc = nullptr;
  EntroEncANS* ans = nullptr;
  std::vector<uint32_t> prev;
  // sim mirrors the decoder's in-progress frame; invariant between frames:
  // sim == prev contentwise (so encode_p skips an 8.3 MB/frame re-copy)
  std::vector<uint32_t> sim;
  bool has_prev = false, has_flat = false;
  int cx = 0, cx1 = 0;
  std::vector<uint8_t> out;

  SpEncoder(int v, int w, int h, int bits)
      : version(v), X(w), Y(h), bpp(bits) {
    nbx = (w + 15) / 16;
    nby = (h + 15) / 16;
    if (v == 2) {
      rc = new EntroEncRC();
      sc_cxshift = bits == 16 ? 0 : 2;
    } else {
      ans = new EntroEncANS(v == 3 ? 64 : 32);
      sc_cxshift = 2;
    }
    prev.assign((size_t)w * h, 0);
    sim.assign((size_t)w * h, 0);
  }
  ~SpEncoder() { delete rc; delete ans; }

  void cx_consts(int* mask, int* s1, int* s) const {
    if (bpp == 16 && rc) { *mask = 0xFF00; *s1 = 2; *s = 16; }
    else { *mask = 0xFC00; *s1 = 4; *s = 18; }
  }
  bool enc_clr(int cxi, int c) {
    if (rc) { rc->clr(cxi, c); return true; }
    return ans->clr(cxi, c);
  }
  void enc_n(int pt, int c) { rc ? rc->nrun(pt, c) : ans->nrun(pt, c); }
  void enc_p(int pt, int c) { rc ? rc->ptype(pt, c) : ans->ptype(pt, c); }
  void enc_x(int c) { rc ? rc->xx(c) : ans->xx(c); }
  void enc_bt(int c) { rc ? rc->bt(c) : ans->bt(c); }
  void enc_bn(int c) { rc ? rc->bn(c) : ans->bn(c); }
  void enc_sxy(int n, int c) { rc ? rc->sxy(n, c) : ans->sxy(n, c); }
  void enc_mx(int c) { rc ? rc->mx(c) : ans->mx(c); }
  void enc_my(int c) { rc ? rc->my(c) : ans->my(c); }

  bool enc_rgb(uint32_t clr) {
    int r = clr & 0xFF, g = (clr >> 8) & 0xFF, b = (clr >> 16) & 0xFF;
    if (!enc_clr(cx + cx1, r)) return false;
    cx1 = (cx << 6) & 0xFC0; cx = r >> sc_cxshift;
    if (!enc_clr(4096 + cx + cx1, g)) return false;
    cx1 = (cx << 6) & 0xFC0; cx = g >> sc_cxshift;
    if (!enc_clr(2 * 4096 + cx + cx1, b)) return false;
    cx1 = (cx << 6) & 0xFC0; cx = b >> sc_cxshift;
    return true;
  }

  int head(int kind) const { return ((version - 1) << 4) | kind; }

  // flat I-frame; clr packed (b<<16)|(g<<8)|r
  int encode_flat(uint32_t clr) {
    out.clear();
    if (bpp == 16) return -1;
    if (!has_flat) { if (rc) rc->renew_i(); else ans->renew_i(); }
    out.push_back((uint8_t)head(1));
    out.push_back((uint8_t)(clr & 0xFF));          // r → decoder "b" slot
    out.push_back((uint8_t)((clr >> 8) & 0xFF));   // g
    out.push_back((uint8_t)((clr >> 16) & 0xFF));  // b
    std::fill(prev.begin(), prev.end(), clr);
    std::fill(sim.begin(), sim.end(), clr);
    has_prev = true;
    has_flat = true;
    return 0;
  }

  static uint32_t grad(uint32_t L, uint32_t U1, uint32_t U0) {
    return SpDecoder::grad(L, U1, U0);
  }

  int run_len_i(const uint32_t* f, size_t di, int p, size_t end) const {
    int n = 0;
    while (n < 255 && di + n < end) {
      size_t pos = di + n;
      uint32_t pred;
      if (p == 1) pred = f[pos - 1];
      else if (p == 2) pred = f[pos - X];
      else if (p == 5) pred = f[pos - X - 1];
      else pred = grad(f[pos - 1], f[pos - X], f[pos - X - 1]);
      if (f[pos] != pred) break;
      n++;
    }
    return n;
  }

  // => 0 ok, -2 unencodable symbol (v3 Cx6 overshoot)
  int encode_i(const uint32_t* f) {
    out.clear();
    has_flat = false;
    if (rc) rc->renew_i(); else ans->renew_i();
    if (rc) rc->begin(); else ans->begin();
    cx = cx1 = 0;
    size_t end = (size_t)X * Y;
    size_t di = 0;
    int k = 0;
    while (k < X + 1) {
      uint32_t clr = f[di];
      int n = 1;
      while (n < 255 && di + n < end && f[di + n] == clr) n++;
      if (!enc_rgb(clr)) return -2;
      enc_n(0, n);
      k += n;
      di += n;
    }
    int maskcx1, shiftcx1, shiftcx;
    cx_consts(&maskcx1, &shiftcx1, &shiftcx);
    int pt = 0;
    while (di < end) {
      int best_p = 0, best_n = 0;
      static const int cands[4] = {1, 2, 4, 5};
      for (int pi = 0; pi < 4; pi++) {
        int n = run_len_i(f, di, cands[pi], end);
        if (n > best_n) { best_p = cands[pi]; best_n = n; }
      }
      if (best_n == 0) {
        best_p = 0;
        uint32_t clr = f[di];
        best_n = 1;
        while (best_n < 255 && di + best_n < end && f[di + best_n] == clr)
          best_n++;
      }
      enc_p(pt, best_p);
      pt = best_p;
      if (best_p == 0) {
        if (!enc_rgb(f[di])) return -2;
      }
      enc_n(best_p, best_n);
      di += best_n;
      uint32_t clr = f[di - 1];
      cx1 = (int)((clr & (uint32_t)maskcx1) >> shiftcx1);
      cx = (int)(clr >> shiftcx);
    }
    out.push_back((uint8_t)head(2));
    if (rc) rc->end(out); else ans->end(out);
    memcpy(prev.data(), f, end * 4);
    memcpy(sim.data(), f, end * 4);
    has_prev = true;
    return 0;
  }

  struct Plan { int x1, y1, x2, y2, mx, my; bool motion, sub; };

  bool find_motion(const uint32_t* cur, int x1, int y1, int x2, int y2,
                   int* omx, int* omy) const {
    static const int cand[][2] = {
        {0, -1}, {0, 1}, {-1, 0}, {1, 0}, {-1, -1}, {1, 1}, {1, -1}, {-1, 1},
        {0, -2}, {0, 2}, {-2, 0}, {2, 0}, {0, -4}, {4, 0}, {-4, 0}, {0, 4},
        {0, -8}, {8, 0}, {-8, 0}, {0, 8},
        // appended round 3 (order-preserving: earlier outputs unchanged):
        // line-height scrolls (text UIs scroll by 12-16 px) and 3 px nudges
        {0, -16}, {0, 16}, {-16, 0}, {16, 0}, {0, -12}, {0, 12},
        {0, -3}, {0, 3}, {-3, 0}, {3, 0}};
    for (auto& mvc : cand) {
      int mx = mvc[0], my = mvc[1];
      if (y1 + my < 0 || y2 + my > Y || x1 + mx < 0 || x2 + mx > X) continue;
      bool ok = true;
      for (int y = y1; y < y2 && ok; y++) {
        const uint32_t* a = &cur[(size_t)y * X + x1];
        const uint32_t* b = &prev[(size_t)(y + my) * X + (x1 + mx)];
        if (memcmp(a, b, (size_t)(x2 - x1) * 4) != 0) ok = false;
      }
      if (ok) { *omx = mx; *omy = my; return true; }
    }
    return false;
  }

  int run_len_p(const uint32_t* cur, const uint32_t* sim, int x1, int y1,
                int x2, int y2, int k, int p, int npos) const {
    int w = x2 - x1;
    long off = -(long)X - 1;
    auto read = [&](long pos, int n) -> uint32_t {
      long y = pos / X, x = pos % X;
      if (y >= y1 && y < y2 && x >= x1 && x < x2) {
        int o = (int)((y - y1) * w + (x - x1));
        if (o >= k && o < k + n) return cur[pos];
      }
      return sim[pos];
    };
    int n = 0;
    while (n < 255 && k + n < npos) {
      int o = k + n;
      long i = (long)(y1 + o / w) * X + (x1 + o % w);
      uint32_t pred;
      if (p == 1) {
        if (i - 1 < 0) break;
        pred = read(i - 1, n);
      } else if (p == 2) {
        if (i + off + 1 < 0) break;
        pred = read(i + off + 1, n);
      } else if (p == 3) {
        pred = prev[i];
      } else if (p == 4) {
        if (i - 1 < 0 || i + off < 0) break;
        pred = grad(read(i - 1, n), read(i + off + 1, n), read(i + off, n));
      } else {
        if (i + off < 0) break;
        pred = read(i + off, n);
      }
      if (cur[i] != pred) break;
      n++;
    }
    return n;
  }

  // => 0 encoded, 1 no-change, -2 unencodable
  int encode_p(const uint32_t* cur) {
    out.clear();
    has_flat = false;
    size_t nb = (size_t)nbx * nby;
    std::vector<int> bts(nb, 0);
    std::vector<Plan> plans(nb);
    bool any = false;
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++) {
        size_t bi = (size_t)by * nbx + bx;
        int x16 = bx * 16, y16 = by * 16;
        int bx2 = x16 + 16 > X ? X : x16 + 16;
        int by2 = y16 + 16 > Y ? Y : y16 + 16;
        int rx1 = bx2, rx2 = x16, ry1 = by2, ry2 = y16;
        size_t wbytes = (size_t)(bx2 - x16) * 4;
        bool same = true;  // memcmp fast path: most blocks are unchanged
        for (int y = y16; y < by2 && same; y++)
          same = memcmp(&cur[(size_t)y * X + x16],
                        &prev[(size_t)y * X + x16], wbytes) == 0;
        if (same) continue;  // unchanged block
        for (int y = y16; y < by2; y++) {
          const uint32_t* a = &cur[(size_t)y * X + x16];
          const uint32_t* b = &prev[(size_t)y * X + x16];
          if (memcmp(a, b, wbytes) == 0) continue;
          for (int x = 0; x < bx2 - x16; x++)
            if (a[x] != b[x]) {
              if (y < ry1) ry1 = y;
              if (y + 1 > ry2) ry2 = y + 1;
              if (x16 + x < rx1) rx1 = x16 + x;
              if (x16 + x + 1 > rx2) rx2 = x16 + x + 1;
            }
        }
        if (ry2 <= ry1) continue;  // unchanged block
        bool use_sub =
            (ry2 - ry1) * (rx2 - rx1) < (by2 - y16) * (bx2 - x16);
        Plan pl;
        // prefer FULL-BLOCK motion (bts 3) even when the dirty rect is
        // smaller: scrolled text regions have sparse diffs but the whole
        // block still moved, and bts 3 skips the 4 sxy coordinate symbols
        // per block — on the terminal corpus those were ~40% of the host
        // stage's symbol decodes (gprof round 3).  Python twin must match.
        if (use_sub
            && find_motion(cur, x16, y16, bx2, by2, &pl.mx, &pl.my)) {
          use_sub = false;
          pl.motion = true;
          pl.x1 = x16; pl.y1 = y16; pl.x2 = bx2; pl.y2 = by2;
          pl.sub = false;
        } else {
          if (use_sub) { pl.x1 = rx1; pl.y1 = ry1; pl.x2 = rx2; pl.y2 = ry2; }
          else { pl.x1 = x16; pl.y1 = y16; pl.x2 = bx2; pl.y2 = by2; }
          pl.sub = use_sub;
          pl.motion = find_motion(cur, pl.x1, pl.y1, pl.x2, pl.y2,
                                  &pl.mx, &pl.my);
        }
        bts[bi] = 1 + (use_sub ? 1 : 0) + (pl.motion ? 2 : 0);
        plans[bi] = pl;
        any = true;
      }
    if (!any) {
      out.push_back(0);
      return 1;
    }
    if (rc) rc->begin(); else ans->begin();
    size_t xx1 = nb, xx2 = 0;
    for (size_t i = 0; i < nb; i++)
      if (bts[i]) { if (i < xx1) xx1 = i; xx2 = i; }
    enc_x((int)(xx1 & 0xFF));
    enc_x((int)(xx1 >> 8));
    enc_x((int)(xx2 & 0xFF));
    enc_x((int)(xx2 >> 8));
    size_t x = xx1;
    while (x <= xx2) {
      int b = bts[x];
      int n = 1;
      while (x + n <= xx2 && bts[x + n] == b && n < 255) n++;
      enc_bt(b);
      enc_bn(n);
      x += n;
    }
    // sim == prev here (invariant maintained across frames)
    int maskcx1, shiftcx1, shiftcx;
    cx_consts(&maskcx1, &shiftcx1, &shiftcx);
    cx = cx1 = 0;
    int lastmx = 0, lastmy = 0;
    bool can_bool = ans != nullptr;
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++) {
        size_t bi = (size_t)by * nbx + bx;
        if (!bts[bi]) continue;
        Plan& pl = plans[bi];
        if ((bts[bi] - 1) & 1) {
          enc_sxy(0, pl.x1 - bx * 16);
          enc_sxy(1, pl.y1 - by * 16);
          enc_sxy(2, pl.x2 - bx * 16 - 1);
          enc_sxy(3, pl.y2 - by * 16 - 1);
        }
        if ((bts[bi] - 1) & 2) {
          if (can_bool) {
            bool same = pl.mx == lastmx && pl.my == lastmy;
            ans->dbool(same);
            if (!same) { enc_mx(pl.mx + MSR_X); enc_my(pl.my + MSR_Y); }
          } else {
            enc_mx(pl.mx + MSR_X);
            enc_my(pl.my + MSR_Y);
          }
          lastmx = pl.mx; lastmy = pl.my;
          for (int y = pl.y1; y < pl.y2; y++)
            memcpy(&sim[(size_t)y * X + pl.x1],
                   &prev[(size_t)(y + pl.my) * X + (pl.x1 + pl.mx)],
                   (size_t)(pl.x2 - pl.x1) * 4);
        } else {
          int w = pl.x2 - pl.x1;
          int npos = w * (pl.y2 - pl.y1);
          int k = 0;
          int pt = 0;
          while (k < npos) {
            int best_p = 0, best_n = 0;
            static const int cands[5] = {1, 2, 3, 4, 5};
            for (int pi = 0; pi < 5; pi++) {
              int n = run_len_p(cur, sim.data(), pl.x1, pl.y1, pl.x2, pl.y2,
                                k, cands[pi], npos);
              if (n > best_n) { best_p = cands[pi]; best_n = n; }
            }
            long i0 = (long)(pl.y1 + k / w) * X + (pl.x1 + k % w);
            if (best_n == 0) {
              best_p = 0;
              uint32_t clr = cur[i0];
              best_n = 1;
              while (best_n < 255 && k + best_n < npos) {
                int o = k + best_n;
                long i = (long)(pl.y1 + o / w) * X + (pl.x1 + o % w);
                if (cur[i] != clr) break;
                best_n++;
              }
            }
            enc_p(pt, best_p);
            pt = best_p;
            if (best_p == 0) {
              if (!enc_rgb(cur[i0])) return -2;
            }
            enc_n(best_p, best_n);
            for (int j = k; j < k + best_n; j++) {
              long i = (long)(pl.y1 + j / w) * X + (pl.x1 + j % w);
              sim[i] = cur[i];
            }
            k += best_n;
            long ilast = (long)(pl.y1 + (k - 1) / w) * X + (pl.x1 + (k - 1) % w);
            uint32_t clr = cur[ilast];
            cx1 = (int)((clr & (uint32_t)maskcx1) >> shiftcx1);
            cx = (int)(clr >> shiftcx);
          }
        }
      }
    out.push_back(1);  // placed below; reorder at the end
    // move the head byte to the front: entropy payload was appended by end()
    // afterwards, so build: [1][payload]
    std::vector<uint8_t> payload;
    if (rc) rc->end(payload); else ans->end(payload);
    out.clear();
    out.push_back(1);
    out.insert(out.end(), payload.begin(), payload.end());
    // prev/sim := cur, but only touched blocks can differ — screen content
    // is mostly stills, so this replaces an 8.3 MB/frame memcpy with a few
    // block copies (sim already holds cur inside every encoded rect)
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++) {
        size_t bi = (size_t)by * nbx + bx;
        if (!bts[bi]) continue;
        int x16 = bx * 16, y16 = by * 16;
        int bx2 = x16 + 16 > X ? X : x16 + 16;
        int by2 = y16 + 16 > Y ? Y : y16 + 16;
        for (int y = y16; y < by2; y++) {
          memcpy(&prev[(size_t)y * X + x16], &cur[(size_t)y * X + x16],
                 (size_t)(bx2 - x16) * 4);
          memcpy(&sim[(size_t)y * X + x16], &cur[(size_t)y * X + x16],
                 (size_t)(bx2 - x16) * 4);
        }
      }
    has_prev = true;
    return 0;
  }
};


// ---------------------------------------------------------------------------
// MSVideo1 frame decoder (paint; semantics = codecs/msvideo1.py)
// ---------------------------------------------------------------------------

struct Msv1Decoder {
  int X, Y, nbx, nby;
  bool is8 = false;
  uint32_t pal[256] = {0};
  ZBuf buf0, buf1;
  std::vector<uint8_t> block_changes;  // per block row
  int cur = 0;
  bool has_prev = false;
  int insignificant_blocks = 0, insign_lines = 0;

  Msv1Decoder(int w, int h, const uint32_t* palette /*null=16bit*/)
      : X(w), Y(h), nbx(w >> 2), nby(h >> 2) {
    if (palette) {
      is8 = true;
      memcpy(pal, palette, 256 * 4);
    }
    buf0.alloc_zero((size_t)w * h);
    buf1.alloc_zero((size_t)w * h);
    block_changes.assign(nby, 0);
  }
  uint32_t* latest() { return cur == 0 ? buf0.data() : buf1.data(); }
  uint32_t* older() { return cur == 0 ? buf1.data() : buf0.data(); }

  void preinit(int lines) {
    insignificant_blocks = (lines + 3) >> 2;
    insign_lines = is8 ? 0 : lines;  // 8-bit quirk preserved
  }
  static uint32_t rgb15(uint32_t c) {
    return ((c & 0x1F) << 3) | ((c & 0x3E0) << 6) | ((c & 0x7C00) << 9);
  }

  // => 0 decoded-new, 1 no-change; *signif out
  int decompress(const uint8_t* src, size_t len, int* signif) {
    *signif = 0;
    uint32_t* d = older();
    uint32_t* pv = latest();
    size_t npix = (size_t)X * Y;
    if (len == 0) return 1;
    if (!is8) {  // 16-bit fast path: just-skips check (MSVideo1.hx:109)
      size_t nblocks = (size_t)nbx * nby;
      size_t sjs = (nblocks / 1023) * 2 + 10;
      if (len < sjs) {
        size_t si = 0, n = 0;
        bool all_skip = true;
        while (si + 1 < len) {
          int a = src[si], b = src[si + 1];
          if ((b & 0xFC) == 0x84) {
            n += ((b - 0x84) << 8) + a;
            if (n >= nblocks) break;
          } else { all_skip = false; break; }
          si += 2;
        }
        if (all_skip) return 1;
      }
    }
    if (has_prev) memcpy(d, pv, npix * 4);
    std::fill(block_changes.begin(), block_changes.end(), 0);
    bool changes = false;
    size_t si = 0;
    int skip = 0;
    bool ended = false;
    for (int by = 0; by < nby && !ended; by++)
      for (int bx = 0; bx < nbx; bx++) {
        if (skip) { skip--; continue; }
        if (si + 2 > len) { ended = true; break; }
        int a = src[si], b = src[si + 1];
        if (is8 && a + b == 0) { ended = true; break; }
        si += 2;
        size_t base = (size_t)by * 4 * X + bx * 4;
        if ((b & 0xFC) == 0x84) {
          skip = ((b - 0x84) << 8) + a - 1;
          continue;
        }
        uint32_t cols[8];
        uint8_t sel[16];
        bool painted = true;
        if (b < 0x80) {
          if (is8) {
            if (si + 2 > len) { ended = true; break; }
            int flags = (b << 8) + a;
            cols[1] = pal[src[si]];
            cols[0] = pal[src[si + 1]];
            si += 2;
            for (int k = 0; k < 16; k++) sel[k] = (flags >> k) & 1;
          } else {
            if (si + 4 > len) { ended = true; break; }
            int flags = ((b << 8) + a) ^ 0xFFFF;
            uint32_t c0 = src[si] | ((uint32_t)src[si + 1] << 8);
            uint32_t c1 = src[si + 2] | ((uint32_t)src[si + 3] << 8);
            si += 4;
            if (c0 & 0x8000) {
              if (si + 12 > len) { ended = true; break; }
              cols[0] = rgb15(c0);
              cols[1] = rgb15(c1);
              for (int k = 2; k < 8; k++) {
                cols[k] = rgb15(src[si] | ((uint32_t)src[si + 1] << 8));
                si += 2;
              }
              for (int k = 0; k < 16; k++) {
                int y = k >> 2, x = k & 3;
                sel[k] = (uint8_t)((((y & 2) << 1) + (x & 2)) + ((flags >> k) & 1));
              }
            } else {
              cols[0] = rgb15(c0);
              cols[1] = rgb15(c1);
              for (int k = 0; k < 16; k++) sel[k] = (flags >> k) & 1;
            }
          }
        } else if (is8 && b >= 0x90) {
          if (si + 8 > len) { ended = true; break; }
          int flags = ((b << 8) + a) ^ 0xFFFF;
          for (int k = 0; k < 8; k++) cols[k] = pal[src[si + k]];
          si += 8;
          for (int k = 0; k < 16; k++) {
            int y = k >> 2, x = k & 3;
            sel[k] = (uint8_t)((((y & 2) << 1) + (x & 2)) + ((flags >> k) & 1));
          }
        } else {
          uint32_t c = is8 ? pal[a] : rgb15((uint32_t)((b << 8) + a));
          cols[0] = c;
          for (int k = 0; k < 16; k++) sel[k] = 0;
        }
        if (painted) {
          for (int k = 0; k < 16; k++)
            d[base + (size_t)(k >> 2) * X + (k & 3)] = cols[sel[k]];
          changes = true;
          block_changes[by] = 1;
        }
      }
    bool sg = false;
    if (changes) {
      for (int i = insignificant_blocks; i < nby; i++)
        if (block_changes[i]) { sg = true; break; }
    }
    if (sg && has_prev) {
      sg = false;
      for (size_t i = (size_t)insign_lines * X; i < npix; i++)
        if (d[i] != pv[i]) { sg = true; break; }
    }
    *signif = sg ? 1 : 0;
    if (changes) {
      cur ^= 1;
      has_prev = true;
      return 0;
    }
    return 1;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------


// ---------------------------------------------------------------------------
// kmv paycode emission (device transport for kernels/sp_recon.prepare_kmv)
// ---------------------------------------------------------------------------
//
// Packs the decoded frame + block commands into the single u32 plane the
// K-distinct-motion-vector device compose consumes:
//   pixel(24b) | ptype(2b: 0 copy, 1 data, 2 motion) | kslot(3b)
// Motion blocks are grouped by distinct vector; the K most frequent get
// slots (ties broken by lexicographic (mx,my) order to match the numpy
// reference implementation), the rest demote to data (the decoded frame
// already carries their pixels).  Exact twin of
// kernels/sp_recon.prepare_kmv, including pixel bits under non-data
// pixels — so paycode & 0xFFFFFF always equals the decoded frame.

static void fill_paycode_i(int npix, const uint32_t* frame, uint32_t* pay) {
  for (int i = 0; i < npix; i++)
    pay[i] = (frame[i] & 0x00FFFFFFu) | (1u << 24);
}

// Paycode semantics (exact twin of kernels/sp_recon.prepare_kmv): pixel
// bits (low 24) are meaningful ONLY where ptype==1 (data); copy and motion
// pixels carry ZERO low bits — compose_frame_kmv never reads them.  That
// zero convention is what makes dirty-block fills possible: a plane whose
// untouched words are 0 is a valid all-copy frame, so a P-frame only has
// to (a) clear the blocks the plane's PREVIOUS occupant wrote and (b)
// write its own non-copy blocks.  At screencast change densities this cuts
// the fill from 8.3 MB/frame (1080p) to the changed blocks only — the fill
// measured 84% of the host stage before (BENCH_NOTES.md round 2).

static void clear_pay_block(int X, int Y, int nbx, long bi, uint32_t* pay) {
  int by = (int)(bi / nbx), bx = (int)(bi % nbx);
  int xb1 = bx * 16, xb2 = xb1 + 16 > X ? X : xb1 + 16;
  int yb1 = by * 16, yb2 = yb1 + 16 > Y ? Y : yb1 + 16;
  for (int y = yb1; y < yb2; y++)
    memset(&pay[(size_t)y * X + xb1], 0, (size_t)(xb2 - xb1) * 4);
}

// Write one non-copy block's paycode words (zero-outside-data semantics).
static void write_pay_block(int X, int Y, int nbx, size_t bi,
                            const int32_t* bts, const int32_t* mv,
                            const int32_t* rect, const uint32_t* frame,
                            const int32_t* mvk, int kk, uint32_t* pay) {
  int by = (int)(bi / nbx), bx = (int)(bi % nbx);
  int xb1 = bx * 16, xb2 = xb1 + 16 > X ? X : xb1 + 16;
  int yb1 = by * 16, yb2 = yb1 + 16 > Y ? Y : yb1 + 16;
  int b = bts[bi];
  int x1 = rect[bi * 4 + 0], y1 = rect[bi * 4 + 1];
  int x2 = rect[bi * 4 + 2], y2 = rect[bi * 4 + 3];
  // full-rect blocks (the common case away from change-region edges) take
  // branch-free row fills — the per-pixel rect compare was 30% of the
  // whole host stage on scroll-heavy content
  bool full = (x1 <= xb1 && y1 <= yb1 && x2 >= xb2 && y2 >= yb2);
  if (b == 3 || b == 4) {  // motion (4 = rect-limited: roll inside rect)
    int mx = mv[bi * 2], my = mv[bi * 2 + 1];
    int slot = -1;
    for (int k = 0; k < kk; k++)
      if (mvk[k * 2] == mx && mvk[k * 2 + 1] == my) { slot = k; break; }
    if (slot >= 0) {
      uint32_t v = (2u << 24) | ((uint32_t)slot << 26);
      if (full) {
        for (int y = yb1; y < yb2; y++) {
          uint32_t* row = &pay[(size_t)y * X + xb1];
          for (int x = 0; x < xb2 - xb1; x++) row[x] = v;
        }
        return;
      }
      for (int y = yb1; y < yb2; y++) {
        uint32_t* row = &pay[(size_t)y * X + xb1];
        for (int x = 0; x < xb2 - xb1; x++) {
          int ax = xb1 + x;
          row[x] = (y >= y1 && y < y2 && ax >= x1 && ax < x2) ? v : 0u;
        }
      }
    } else {  // demoted: whole block rides as data
      for (int y = yb1; y < yb2; y++) {
        const uint32_t* f = &frame[(size_t)y * X + xb1];
        uint32_t* row = &pay[(size_t)y * X + xb1];
        for (int x = 0; x < xb2 - xb1; x++)
          row[x] = (f[x] & 0x00FFFFFFu) | (1u << 24);
      }
    }
  } else {  // data / subrect
    if (full) {
      for (int y = yb1; y < yb2; y++) {
        const uint32_t* f = &frame[(size_t)y * X + xb1];
        uint32_t* row = &pay[(size_t)y * X + xb1];
        for (int x = 0; x < xb2 - xb1; x++)
          row[x] = (f[x] & 0x00FFFFFFu) | (1u << 24);
      }
      return;
    }
    for (int y = yb1; y < yb2; y++) {
      const uint32_t* f = &frame[(size_t)y * X + xb1];
      uint32_t* row = &pay[(size_t)y * X + xb1];
      for (int x = 0; x < xb2 - xb1; x++) {
        int ax = xb1 + x;
        row[x] = (y >= y1 && y < y2 && ax >= x1 && ax < x2)
                     ? ((f[x] & 0x00FFFFFFu) | (1u << 24)) : 0u;
      }
    }
  }
}

// Group motion vectors into the K most frequent slots (numpy parity:
// unique() sorts lexicographically, argsort(-counts) is stable -> ties
// resolve in lexicographic order).  Shared by the kmv and bc transports.
static int group_mvk(size_t nb, const int32_t* bts, const int32_t* mv,
                     int K, int32_t* mvk) {
  struct V { int mx, my, cnt; };
  std::vector<V> vs;
  for (size_t bi = 0; bi < nb; bi++) {
    if (bts[bi] != 3 && bts[bi] != 4) continue;  // 4 = subrect motion
    int mx = mv[bi * 2], my = mv[bi * 2 + 1];
    int f = -1;
    for (size_t j = 0; j < vs.size(); j++)
      if (vs[j].mx == mx && vs[j].my == my) { f = (int)j; break; }
    if (f < 0) { vs.push_back({mx, my, 0}); f = (int)vs.size() - 1; }
    vs[f].cnt++;
  }
  std::sort(vs.begin(), vs.end(), [](const V& a, const V& b) {
    return a.mx != b.mx ? a.mx < b.mx : a.my < b.my;
  });
  std::stable_sort(vs.begin(), vs.end(),
                   [](const V& a, const V& b) { return a.cnt > b.cnt; });
  memset(mvk, 0, (size_t)K * 8);
  int kk = (int)vs.size() < K ? (int)vs.size() : K;
  for (int k = 0; k < kk; k++) {
    mvk[k * 2] = vs[k].mx;
    mvk[k * 2 + 1] = vs[k].my;
  }
  return kk;
}

// dirty_io: [0] = count of block indices (following) that the plane's
// previous occupant wrote (-1 = whole plane may be nonzero, e.g. after an
// I-frame), or NULL for the stateless full-plane fill.  On return (when
// non-NULL) it lists this frame's non-copy blocks.
static void fill_paycode_p(int X, int Y, int nbx, int nby,
                           const int32_t* bts, const int32_t* mv,
                           const int32_t* rect, const uint32_t* frame,
                           int K, uint32_t* pay, int32_t* mvk,
                           int32_t* dirty_io) {
  size_t nb = (size_t)nbx * nby;
  int kk = group_mvk(nb, bts, mv, K, mvk);

  if (dirty_io != nullptr && dirty_io[0] >= 0) {
    // incremental: clear the previous occupant's blocks, write ours
    int nprev = dirty_io[0];
    for (int i = 0; i < nprev; i++)
      clear_pay_block(X, Y, nbx, dirty_io[1 + i], pay);
    int nnew = 0;
    for (size_t bi = 0; bi < nb; bi++) {
      if (bts[bi] <= 0) continue;
      write_pay_block(X, Y, nbx, bi, bts, mv, rect, frame, mvk, kk, pay);
      dirty_io[1 + nnew++] = (int32_t)bi;
    }
    dirty_io[0] = nnew;
    return;
  }
  // full-plane fill (stateless callers, or plane in unknown state)
  int nnew = 0;
  for (size_t bi = 0; bi < nb; bi++) {
    if (bts[bi] <= 0) {
      clear_pay_block(X, Y, nbx, (long)bi, pay);
    } else {
      write_pay_block(X, Y, nbx, bi, bts, mv, rect, frame, mvk, kk, pay);
      if (dirty_io != nullptr) dirty_io[1 + nnew++] = (int32_t)bi;
    }
  }
  if (dirty_io != nullptr) dirty_io[0] = nnew;
}

extern "C" {

void* sp_create(int width, int height, int bpp) {
  return new SpDecoder(width, height, bpp);
}
void sp_destroy(void* p) { delete (SpDecoder*)p; }
void sp_preinit(void* p, int insign_lines) {
  ((SpDecoder*)p)->preinit(insign_lines);
}
int sp_is_key_frame(const uint8_t* src, long len) {
  if (len == 0) return 0;
  uint8_t b = src[0];
  return (b == 0x12 || b == 0x11 || b == 0x22 || b == 0x21 || b == 0x32 ||
          b == 0x31)
             ? 1
             : 0;
}
// returns 0 ok / 1 no-change / -1 error
int sp_decompress(void* p, const uint8_t* src, long len, int is_key,
                  uint32_t* dst, int* signif, int32_t* cap_bts,
                  int32_t* cap_mv, int32_t* cap_rect) {
  SpDecoder* d = (SpDecoder*)p;
  if (is_key) {
    int r = d->decompress_i(src, (size_t)len, dst);
    *signif = 0;
    if (cap_bts) {
      size_t nb = (size_t)d->nbx * d->nby;
      for (size_t i = 0; i < nb; i++) cap_bts[i] = 1;
      if (cap_mv) memset(cap_mv, 0, nb * 8);
      if (cap_rect)
        for (int by = 0; by < d->nby; by++)
          for (int bx = 0; bx < d->nbx; bx++) {
            size_t bi = (size_t)by * d->nbx + bx;
            cap_rect[bi * 4 + 0] = bx * 16;
            cap_rect[bi * 4 + 1] = by * 16;
            cap_rect[bi * 4 + 2] = bx * 16 + 16 > d->X ? d->X : bx * 16 + 16;
            cap_rect[bi * 4 + 3] = by * 16 + 16 > d->Y ? d->Y : by * 16 + 16;
          }
    }
    return r;
  }
  return d->decompress_p(src, (size_t)len, dst, signif, cap_bts, cap_mv,
                         cap_rect);
}
// debug: export clr-context kinds (0..7) and coarse state fingerprints
void sp_debug_oplog(uint32_t* buf, long cap) {
  g_oplog = buf;
  g_oplog_cap = cap;
  g_oplog_n = 0;
}
long sp_debug_oplog_count() { return g_oplog_n; }

static uint32_t fixed_fp(const FixedCtx& t) {
  uint32_t h = t.cntsum;
  for (int j = 0; j < t.nsym; j++)
    h = h * 131 + t.freq[j] * 3 + t.cumfreq[j] * 5 + t.cnts[j];
  return h;
}
// ftabs: 6 ntab + 6 ptype + xx + ntab2 + bt + 4 sxy + 2 mv = 21 entries
void sp_debug_ftabs(void* p, uint32_t* out) {
  SpDecoder* d = (SpDecoder*)p;
  if (!d->ans) return;
  int k = 0;
  for (int i = 0; i < NCXMAX; i++) out[k++] = fixed_fp(d->ans->ntab[i]);
  for (int i = 0; i < 6; i++) out[k++] = fixed_fp(d->ans->ptypetab[i]);
  out[k++] = fixed_fp(d->ans->xxtab);
  out[k++] = fixed_fp(d->ans->ntab2);
  out[k++] = fixed_fp(d->ans->bttab);
  for (int i = 0; i < 4; i++) out[k++] = fixed_fp(d->ans->sxytab[i]);
  for (int i = 0; i < 2; i++) out[k++] = fixed_fp(d->ans->mvtab[i]);
}
void sp_debug_ctx(void* p, uint8_t* kinds, uint32_t* fp) {
  SpDecoder* d = (SpDecoder*)p;
  if (!d->ans) return;
  for (size_t i = 0; i < d->ans->cntab.size(); i++) {
    Context& c = d->ans->cntab[i];
    kinds[i] = (uint8_t)c.kind;
    uint32_t h = 0;
    if (c.kind >= K1 && c.kind <= K3) {
      h = c.list_d;
      for (int j = 0; j < c.list_d; j++) h = h * 131 + c.list[j];
    } else if (c.kind == K4 || c.kind == K5) {
      h = c.sc->d * 1000003u + c.sc->maxpos;
      for (int j = 0; j < c.sc->d; j++)
        h = h * 131 + c.sc->symbols[j] * 7 + c.sc->freqs[j];
      if (c.kind == K5) h = h * 131 + c.sc->cntsum;
    } else if (c.kind == K6) {
      h = c.c6->d * 1000003u + c.c6->fshift * 31 + c.c6->cntsum;
      for (int j = 0; j < c.c6->d; j++)
        h = h * 131 + c.c6->symbols[j] * 7 + c.c6->freq[j] * 3
            + c.c6->cumfreq[j] * 5 + c.c6->cnts[j];
    } else if (c.kind == K7) {
      h = c.c7->cntsum;
      for (int j = 0; j < 256; j++)
        h = h * 131 + c.c7->freq[j] * 3 + c.c7->cumfreq[j] * 5 + c.c7->cnts[j];
    }
    fp[i] = h;
  }
}
const uint32_t* sp_prev_frame(void* p, int* has) {
  SpDecoder* d = (SpDecoder*)p;
  *has = d->has_prev ? 1 : 0;
  return d->latest();
}

int msv1_parse_commands(const uint8_t* src, long len, int X, int Y,
                        const uint32_t* pal, uint8_t* btype, uint8_t* sel,
                        uint32_t* colors) {
  return msv1_parse(src, (size_t)len, X, Y, pal, btype, sel, colors);
}

// Parallel multi-stream batch decode: nstreams independent streams, each
// frames_per_stream frames; frame f of stream b is blob[offsets[b*F+f] ..
// +lengths[b*F+f]].  Outputs per frame: payload plane, commands (bts/mv/
// rect), changed + signif flags.  Streams decode in parallel on a thread
// pool — the host-side DP axis (SURVEY.md §2).
int sp_decode_streams(int nstreams, int frames_per_stream, int width,
                      int height, int bpp, const uint8_t* blob,
                      const long* offsets, const long* lengths,
                      int insign_lines, uint32_t* payloads, int32_t* bts,
                      int32_t* mv, int32_t* rect, uint8_t* changed,
                      uint8_t* signif, int nthreads) {
  const size_t npix = (size_t)width * height;
  const size_t nb =
      (size_t)((width + 15) / 16) * (size_t)((height + 15) / 16);
  std::atomic<int> next{0};
  std::atomic<int> errors{0};
  auto work = [&]() {
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= nstreams) return;
      SpDecoder dec(width, height, bpp);
      dec.preinit(insign_lines);
      for (int f = 0; f < frames_per_stream; f++) {
        size_t fi = (size_t)b * frames_per_stream + f;
        const uint8_t* src = blob + offsets[fi];
        long len = lengths[fi];
        int is_key = sp_is_key_frame(src, len);
        int sg = 0;
        int r;
        if (is_key) {
          r = dec.decompress_i(src, (size_t)len, nullptr);
          if (r == 0) {
            for (size_t i = 0; i < nb; i++) bts[fi * nb + i] = 1;
            memset(&mv[fi * nb * 2], 0, nb * 8);
            for (int by = 0; by < dec.nby; by++)
              for (int bx = 0; bx < dec.nbx; bx++) {
                size_t bi = (size_t)by * dec.nbx + bx;
                int32_t* rr = &rect[(fi * nb + bi) * 4];
                rr[0] = bx * 16;
                rr[1] = by * 16;
                rr[2] = bx * 16 + 16 > width ? width : bx * 16 + 16;
                rr[3] = by * 16 + 16 > height ? height : by * 16 + 16;
              }
          }
        } else {
          r = dec.decompress_p(src, (size_t)len, nullptr, &sg,
                               &bts[fi * nb], &mv[fi * nb * 2],
                               &rect[fi * nb * 4]);
        }
        if (r == -1) {
          errors.fetch_add(1);
          changed[fi] = 0;
          signif[fi] = 0;
          // quarantine: keep the last good frame for the rest of the stream
          for (int g = f; g < frames_per_stream; g++) {
            size_t gi = (size_t)b * frames_per_stream + g;
            changed[gi] = 0;
            signif[gi] = 0;
            memcpy(&payloads[gi * npix], dec.latest(), npix * 4);
          }
          break;
        }
        changed[fi] = r == 0 ? 1 : 0;
        signif[fi] = (uint8_t)sg;
        memcpy(&payloads[fi * npix], dec.latest(), npix * 4);
      }
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > nstreams) nt = nstreams;
  std::vector<std::thread> pool;
  for (int i = 1; i < nt; i++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return errors.load();
}

// Per-frame kmv decode on a persistent handle (window-based ingest: the
// decoder's entropy/context state spans windows).  Returns 0 decoded-new /
// 1 no-change (paycode NOT written) / -1 error.
// dirty_io: optional per-plane incremental-fill state (see fill_paycode_p);
// must have room for 1 + nbx*nby int32s.  Callers start a freshly ZEROED
// plane with dirty_io[0] = 0.  NULL keeps the stateless full-plane fill.
int sp_decompress_kmv2(void* p, const uint8_t* src, long len, int is_key,
                       int K, uint32_t* paycode, int32_t* mvk, int* signif,
                       int32_t* dirty_io) {
  SpDecoder* d = (SpDecoder*)p;
  size_t npix = (size_t)d->X * d->Y;
  *signif = 0;
  if (is_key) {
    int r = d->decompress_i(src, (size_t)len, nullptr);
    if (r != 0) return r;
    *signif = 1;
    fill_paycode_i((int)npix, d->latest(), paycode);
    memset(mvk, 0, (size_t)K * 8);
    if (dirty_io != nullptr) dirty_io[0] = -1;  // whole plane nonzero
    return 0;
  }
  // no-change early-out BEFORE any scratch/memset work (mirrors
  // decompress_p's own r==1 conditions): on still-heavy screencasts
  // (~45% of terminal-corpus frames) the per-frame fixed cost drops to
  // this test (VERDICT round-3 item 5)
  if (len == 0 || !d->decoded_i || src[0] == 0) return 1;
  d->ensure_scratch();
  int32_t *cb = d->scr_cb.data(), *cm = d->scr_cm.data(),
          *cr = d->scr_cr.data();
  int r = d->decompress_p(src, (size_t)len, nullptr, signif, cb, cm, cr);
  if (r != 0) return r;  // no-change: plane untouched, dirty kept
  fill_paycode_p(d->X, d->Y, d->nbx, d->nby, cb, cm, cr,
                 d->latest(), K, paycode, mvk, dirty_io);
  return 0;
}

int sp_decompress_kmv(void* p, const uint8_t* src, long len, int is_key,
                      int K, uint32_t* paycode, int32_t* mvk, int* signif) {
  return sp_decompress_kmv2(p, src, len, is_key, K, paycode, mvk, signif,
                            nullptr);
}

// ---------------------------------------------------------------------------
// bc transport: block-command arrays + pixel-only plane.
//
// The kmv paycode packs ptype/kslot into every PIXEL, forcing the host to
// fill motion blocks with constant words and to clear stale blocks (dirty
// tracking).  The bc transport moves the block structure into two small
// per-block arrays — bcode [NB] u8 (0 copy / 1 data / 2+k motion-slot) and
// block-LOCAL rects [NB,4] u8 — that the device broadcasts (structured
// broadcasts are ~free, kernels/sp_recon.compose_frame_bc); the u32 plane
// carries ONLY data-rect pixels, and bytes outside data rects are never
// read.  Consequences for the host stage: no motion fills, no clears, no
// dirty state — the fill cost collapses to the data pixels themselves
// (VERDICT round-2 item 5: "skip payload capture for motion/still blocks").

static void fill_bc_p(int X, int Y, int nbx, int nby, const int32_t* bts,
                      const int32_t* mv, const int32_t* rect,
                      const uint32_t* frame, int K, uint32_t* plane,
                      int32_t* mvk, uint8_t* bcode, uint8_t* rloc) {
  size_t nb = (size_t)nbx * nby;
  int kk = group_mvk(nb, bts, mv, K, mvk);
  memset(bcode, 0, nb);
  for (size_t bi = 0; bi < nb; bi++) {
    int b = bts[bi];
    uint8_t* rl = &rloc[bi * 4];
    if (b <= 0) continue;  // copy: bcode 0, rect ignored
    int by = (int)(bi / nbx), bx = (int)(bi % nbx);
    int xb1 = bx * 16, yb1 = by * 16;
    auto clip16 = [](int v) { return v < 0 ? 0 : (v > 16 ? 16 : v); };
    int lx1 = clip16(rect[bi * 4 + 0] - xb1);
    int ly1 = clip16(rect[bi * 4 + 1] - yb1);
    int lx2 = clip16(rect[bi * 4 + 2] - xb1);
    int ly2 = clip16(rect[bi * 4 + 3] - yb1);
    if (b == 3 || b == 4) {
      int mx = mv[bi * 2], my = mv[bi * 2 + 1];
      int slot = -1;
      for (int k = 0; k < kk; k++)
        if (mvk[k * 2] == mx && mvk[k * 2 + 1] == my) { slot = k; break; }
      if (slot >= 0) {  // motion: NO plane writes at all
        bcode[bi] = (uint8_t)(2 + slot);
        rl[0] = (uint8_t)lx1; rl[1] = (uint8_t)ly1;
        rl[2] = (uint8_t)lx2; rl[3] = (uint8_t)ly2;
        continue;
      }
      // demoted: full-block data (prepare_kmv's `is_data |= demoted`)
      lx1 = 0; ly1 = 0; lx2 = 16; ly2 = 16;
    }
    bcode[bi] = 1;
    rl[0] = (uint8_t)lx1; rl[1] = (uint8_t)ly1;
    rl[2] = (uint8_t)lx2; rl[3] = (uint8_t)ly2;
    // write the data-rect pixels (and only them)
    int xa1 = xb1 + lx1, xa2 = xb1 + lx2; if (xa2 > X) xa2 = X;
    int ya1 = yb1 + ly1, ya2 = yb1 + ly2; if (ya2 > Y) ya2 = Y;
    for (int y = ya1; y < ya2; y++) {
      const uint32_t* f = &frame[(size_t)y * X + xa1];
      uint32_t* row = &plane[(size_t)y * X + xa1];
      for (int x = 0; x < xa2 - xa1; x++) row[x] = f[x] & 0x00FFFFFFu;
    }
  }
}

// Per-frame bc decode on a persistent handle.  Returns 0 decoded-new /
// 1 no-change (outputs untouched) / -1 error.  I-frames: full-plane copy,
// bcode all 1, full rects.
int sp_decompress_bc(void* p, const uint8_t* src, long len, int is_key,
                     int K, uint32_t* plane, int32_t* mvk, uint8_t* bcode,
                     uint8_t* rloc, int* signif) {
  SpDecoder* d = (SpDecoder*)p;
  size_t nb = (size_t)d->nbx * d->nby;
  size_t npix = (size_t)d->X * d->Y;
  *signif = 0;
  if (is_key) {
    int r = d->decompress_i(src, (size_t)len, nullptr);
    if (r != 0) return r;
    *signif = 1;
    const uint32_t* f = d->latest();
    for (size_t i = 0; i < npix; i++) plane[i] = f[i] & 0x00FFFFFFu;
    memset(mvk, 0, (size_t)K * 8);
    memset(bcode, 1, nb);
    for (size_t bi = 0; bi < nb; bi++) {
      rloc[bi * 4 + 0] = 0; rloc[bi * 4 + 1] = 0;
      rloc[bi * 4 + 2] = 16; rloc[bi * 4 + 3] = 16;
    }
    return 0;
  }
  // no-change early-out before any scratch work (see sp_decompress_kmv2)
  if (len == 0 || !d->decoded_i || src[0] == 0) return 1;
  d->ensure_scratch();
  int32_t *cb = d->scr_cb.data(), *cm = d->scr_cm.data(),
          *cr = d->scr_cr.data();
  int r = d->decompress_p(src, (size_t)len, nullptr, signif, cb, cm, cr);
  if (r != 0) return r;
  fill_bc_p(d->X, d->Y, d->nbx, d->nby, cb, cm, cr,
            d->latest(), K, plane, mvk, bcode, rloc);
  return 0;
}

// Batch variant (thread pool over streams) emitting the bc transport:
// plane [B*T*npix] u32 (only data-rect pixels defined where changed),
// mvk [B*T*K*2] i32, bcode [B*T*NB] u8, rloc [B*T*NB*4] u8.
int sp_decode_streams_bc(int nstreams, int frames_per_stream, int width,
                         int height, int bpp, const uint8_t* blob,
                         const long* offsets, const long* lengths,
                         int insign_lines, int K, uint32_t* plane,
                         int32_t* mvk, uint8_t* bcode, uint8_t* rloc,
                         uint8_t* changed, uint8_t* signif, int nthreads) {
  const size_t npix = (size_t)width * height;
  const size_t nb = (size_t)((width + 15) / 16) * ((height + 15) / 16);
  std::atomic<int> next{0};
  std::atomic<int> errors{0};
  auto work = [&]() {
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= nstreams) return;
      SpDecoder dec(width, height, bpp);
      dec.preinit(insign_lines);
      for (int f = 0; f < frames_per_stream; f++) {
        size_t fi = (size_t)b * frames_per_stream + f;
        const uint8_t* src = blob + offsets[fi];
        long len = lengths[fi];
        int sg = 0;
        int r = sp_decompress_bc(&dec, src, len, sp_is_key_frame(src, len),
                                 K, &plane[fi * npix],
                                 &mvk[fi * (size_t)K * 2], &bcode[fi * nb],
                                 &rloc[fi * nb * 4], &sg);
        if (r == -1) {
          errors.fetch_add(1);
          for (int g = f; g < frames_per_stream; g++) {
            size_t gi = (size_t)b * frames_per_stream + g;
            changed[gi] = 0;
            signif[gi] = 0;
          }
          break;
        }
        changed[fi] = r == 0 ? 1 : 0;
        signif[fi] = (uint8_t)sg;
      }
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > nstreams) nt = nstreams;
  std::vector<std::thread> pool;
  for (int i = 1; i < nt; i++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return errors.load();
}

// Per-frame SPARSE kmv transport on a persistent handle (the serving shape
// for PCIe/network-fed hosts): per-block codes + K motion vectors + final-
// content payload tiles.  Exact twin of kernels/sp_recon.prepare_kmv_sparse
// for one frame (same grouping, tie-break, slot-safety vs the previous
// decoded frame, clamped tile origins, block-0 pad tiles).
// Returns 0 decoded / 1 no-change (outputs untouched) / -1 error /
// -2 tile overflow (frame IS decoded; *m_used holds the needed count —
// fall back to latest() as a dense frame).
int sp_decompress_kmv_sparse(void* h, const uint8_t* src, long len,
                             int is_key, int K, int m_cap, uint8_t* bcode,
                             int32_t* mvk, uint32_t* tiles, int32_t* tile_yx,
                             int32_t* m_used, int* signif) {
  SpDecoder* d = (SpDecoder*)h;
  const int X = d->X, Y = d->Y, nbx = d->nbx, nby = d->nby;
  const size_t nb = (size_t)nbx * nby;
  *signif = 0;
  *m_used = 0;
  auto emit_all_tiles = [&](const uint32_t* f) {
    int m = 0;
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++, m++) {
        int y0 = by * 16 > Y - 16 ? Y - 16 : by * 16;
        int x0 = bx * 16 > X - 16 ? X - 16 : bx * 16;
        for (int y = 0; y < 16; y++)
          for (int x = 0; x < 16; x++)
            tiles[(size_t)m * 256 + y * 16 + x] =
                f[(size_t)(y0 + y) * X + (x0 + x)] & 0x00FFFFFFu;
        tile_yx[m * 2] = y0;
        tile_yx[m * 2 + 1] = x0;
      }
  };
  if (is_key) {
    int r = d->decompress_i(src, (size_t)len, nullptr);
    if (r != 0) return r;
    *signif = 1;
    *m_used = (int32_t)nb;
    if (m_cap < (int)nb) return -2;  // ship latest() dense instead
    memset(bcode, 0, nb);
    memset(mvk, 0, (size_t)K * 8);
    emit_all_tiles(d->latest());
    return 0;
  }
  // no-change early-out before any scratch work (see sp_decompress_kmv2)
  if (len == 0 || !d->decoded_i || src[0] == 0) return 1;
  d->ensure_scratch();
  int32_t *cb = d->scr_cb.data(), *cm = d->scr_cm.data(),
          *cr = d->scr_cr.data();
  int r = d->decompress_p(src, (size_t)len, nullptr, signif, cb, cm, cr);
  if (r != 0) return r;
  const uint32_t* curf = d->latest();
  const uint32_t* prevf = d->older();
  // group motion vectors (bts 3|4), numpy-parity ordering
  struct V { int mx, my, cnt; };
  std::vector<V> vs;
  for (size_t bi = 0; bi < nb; bi++) {
    if (cb[bi] != 3 && cb[bi] != 4) continue;
    int mx = cm[bi * 2], my = cm[bi * 2 + 1];
    int f = -1;
    for (size_t j = 0; j < vs.size(); j++)
      if (vs[j].mx == mx && vs[j].my == my) { f = (int)j; break; }
    if (f < 0) { vs.push_back({mx, my, 0}); f = (int)vs.size() - 1; }
    vs[f].cnt++;
  }
  std::sort(vs.begin(), vs.end(), [](const V& a, const V& b) {
    return a.mx != b.mx ? a.mx < b.mx : a.my < b.my;
  });
  std::stable_sort(vs.begin(), vs.end(),
                   [](const V& a, const V& b) { return a.cnt > b.cnt; });
  memset(mvk, 0, (size_t)K * 8);
  int kk = (int)vs.size() < K ? (int)vs.size() : K;
  for (int k = 0; k < kk; k++) {
    mvk[k * 2] = vs[k].mx;
    mvk[k * 2 + 1] = vs[k].my;
  }
  memset(bcode, 0, nb);
  int used = 0;
  auto emit_tile = [&](int by, int bx) {
    if (used < m_cap) {
      int y0 = by * 16 > Y - 16 ? Y - 16 : by * 16;
      int x0 = bx * 16 > X - 16 ? X - 16 : bx * 16;
      for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++)
          tiles[(size_t)used * 256 + y * 16 + x] =
              curf[(size_t)(y0 + y) * X + (x0 + x)] & 0x00FFFFFFu;
      tile_yx[used * 2] = y0;
      tile_yx[used * 2 + 1] = x0;
    }
    used++;
  };
  for (int by = 0; by < nby; by++)
    for (int bx = 0; bx < nbx; bx++) {
      size_t bi = (size_t)by * nbx + bx;
      int b = cb[bi];
      if (b <= 0) continue;
      if (b == 3 || b == 4) {
        int mx = cm[bi * 2], my = cm[bi * 2 + 1];
        int slot = -1;
        for (int k = 0; k < kk; k++)
          if (mvk[k * 2] == mx && mvk[k * 2 + 1] == my) { slot = k; break; }
        bool safe = false;
        if (slot >= 0) {
          int y1 = by * 16, y2 = (by * 16 + 16 > Y) ? Y : by * 16 + 16;
          int x1 = bx * 16, x2 = (bx * 16 + 16 > X) ? X : bx * 16 + 16;
          if (y1 + my >= 0 && y2 + my <= Y && x1 + mx >= 0 && x2 + mx <= X) {
            safe = true;
            for (int y = y1; y < y2 && safe; y++) {
              const uint32_t* a = &curf[(size_t)y * X + x1];
              const uint32_t* p = &prevf[(size_t)(y + my) * X + x1 + mx];
              for (int x = 0; x < x2 - x1; x++)
                if ((a[x] ^ p[x]) & 0x00FFFFFFu) { safe = false; break; }
            }
          }
        }
        if (safe) {
          bcode[bi] = (uint8_t)(2 + slot);
        } else {
          emit_tile(by, bx);
        }
      } else {
        emit_tile(by, bx);
      }
    }
  *m_used = used;
  if (used > m_cap) return -2;
  // pad with block (0,0)'s final content — a no-op rewrite
  for (int m = used; m < m_cap; m++) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++)
        tiles[(size_t)m * 256 + y * 16 + x] =
            curf[(size_t)y * X + x] & 0x00FFFFFFu;
    tile_yx[m * 2] = 0;
    tile_yx[m * 2 + 1] = 0;
  }
  return 0;
}

// Batch variant of sp_decode_streams emitting kmv transport directly:
// paycode [B*T*npix] u32 (undefined where changed==0), mvk [B*T*K*2] i32.
// dirty: optional [nstreams*frames_per_stream rows x (1 + nbx*nby)] i32 —
// per-plane incremental-fill state persisting across calls that reuse the
// same paycode buffers (see fill_paycode_p).  NULL = full-plane fills.
int sp_decode_streams_kmv(int nstreams, int frames_per_stream, int width,
                          int height, int bpp, const uint8_t* blob,
                          const long* offsets, const long* lengths,
                          int insign_lines, int K, uint32_t* paycode,
                          int32_t* mvk, uint8_t* changed, uint8_t* signif,
                          int nthreads, int32_t* dirty) {
  const size_t npix = (size_t)width * height;
  const size_t nb1 = 1 + (size_t)((width + 15) / 16) * ((height + 15) / 16);
  std::atomic<int> next{0};
  std::atomic<int> errors{0};
  auto work = [&]() {
    for (;;) {
      int b = next.fetch_add(1);
      if (b >= nstreams) return;
      SpDecoder dec(width, height, bpp);
      dec.preinit(insign_lines);
      for (int f = 0; f < frames_per_stream; f++) {
        size_t fi = (size_t)b * frames_per_stream + f;
        const uint8_t* src = blob + offsets[fi];
        long len = lengths[fi];
        int sg = 0;
        int r = sp_decompress_kmv2(&dec, src, len,
                                  sp_is_key_frame(src, len), K,
                                  &paycode[fi * npix], &mvk[fi * (size_t)K * 2],
                                  &sg,
                                  dirty != nullptr ? &dirty[fi * nb1]
                                                   : nullptr);
        if (r == -1) {
          errors.fetch_add(1);
          for (int g = f; g < frames_per_stream; g++) {
            size_t gi = (size_t)b * frames_per_stream + g;
            changed[gi] = 0;
            signif[gi] = 0;
          }
          break;
        }
        changed[fi] = r == 0 ? 1 : 0;
        signif[fi] = (uint8_t)sg;
      }
    }
  };
  int nt = nthreads > 0 ? nthreads : 1;
  if (nt > nstreams) nt = nstreams;
  std::vector<std::thread> pool;
  for (int i = 1; i < nt; i++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return errors.load();
}

void* spenc_create(int version, int width, int height, int bpp) {
  return new SpEncoder(version, width, height, bpp);
}
void spenc_destroy(void* p) { delete (SpEncoder*)p; }
// kind: 0 = auto P, 1 = force I, 2 = flat (clr = first pixel)
// returns length or negative error; bytes retrieved via spenc_data
long spenc_encode(void* p, const uint32_t* frame, int kind) {
  SpEncoder* e = (SpEncoder*)p;
  int r;
  if (kind == 2) r = e->encode_flat(frame[0]);
  else if (kind == 1 || !e->has_prev) r = e->encode_i(frame);
  else r = e->encode_p(frame);
  if (r == -2 || r == -1) return -2;
  return (long)e->out.size();
}
const uint8_t* spenc_data(void* p) { return ((SpEncoder*)p)->out.data(); }

void* msv1_create(int width, int height, const uint32_t* palette) {
  return new Msv1Decoder(width, height, palette);
}
void msv1_destroy(void* p) { delete (Msv1Decoder*)p; }
void msv1_preinit(void* p, int insign_lines) {
  ((Msv1Decoder*)p)->preinit(insign_lines);
}
// => 0 decoded-new / 1 no-change
int msv1_decompress(void* p, const uint8_t* src, long len, uint32_t* dst,
                    int* signif) {
  Msv1Decoder* d = (Msv1Decoder*)p;
  int r = d->decompress(src, (size_t)len, signif);
  if (dst) memcpy(dst, d->latest(), (size_t)d->X * d->Y * 4);
  return r;
}
const uint32_t* msv1_latest(void* p) { return ((Msv1Decoder*)p)->latest(); }

// Host lane-container compose (codecs/lane_host.compose_steps twin): walk
// frames [t0, t1) of one window IN PLACE on `plane` ([Y*X] u32, stride X).
// Per changed frame: scatter the shipped 128-px unit rows into the padded
// `pool` plane ([Y*Xp] u32 — caller zero-initializes ONCE; this function
// restores the touched rows to zero after every frame, so the zero
// invariant holds across calls), gather every motion block's source rect
// from the PRISTINE t-1 plane (np.roll wrap semantics), then paint data
// rects from the pool and motion rects from the gathered scratch.  This
// is the interactive-seek hot path (Main.hx:1220-1226 cost model): the
// numpy compose paid ~4.5 ms per changed 1080p frame; this walk is pure
// rect memcpy.
int lane_compose_range(uint32_t* plane, uint32_t* pool,
                       const uint32_t* units, int Y, int X, int Xp, int K,
                       int NB, int T, int t0, int t1,
                       const uint8_t* changed, const uint8_t* btype,
                       const uint8_t* rect, const int32_t* mvk,
                       const int64_t* row_ptr, const int64_t* rows,
                       const int64_t* refs) {
  if (t0 < 0 || t1 > T || Xp < X || NB <= 0) return -1;
  const int nbx = (X + 15) / 16;
  std::vector<uint32_t> scratch;   // motion-source rects, 256 px per block
  std::vector<int> mblocks;        // indices of motion blocks this frame
  for (int t = t0; t < t1; t++) {
    if (!changed[t]) continue;
    // 1. scatter shipped unit rows
    for (int64_t j = row_ptr[t]; j < row_ptr[t + 1]; j++)
      memcpy(pool + rows[j] * 128, units + refs[j] * 128, 128 * 4);
    const uint8_t* bt = btype + (size_t)t * NB;
    const uint8_t* rc = rect + (size_t)t * NB * 4;
    const int32_t* mv = mvk + (size_t)t * K * 2;
    // 2. gather motion sources from the pristine t-1 plane
    mblocks.clear();
    for (int b = 0; b < NB; b++)
      if (bt[b] >= 2) mblocks.push_back(b);
    if (scratch.size() < mblocks.size() * 256)
      scratch.resize(mblocks.size() * 256);
    for (size_t m = 0; m < mblocks.size(); m++) {
      int b = mblocks[m];
      int bx = b % nbx, by = b / nbx;
      int ax1 = bx * 16 + rc[b * 4 + 0], ay1 = by * 16 + rc[b * 4 + 1];
      int ax2 = bx * 16 + rc[b * 4 + 2], ay2 = by * 16 + rc[b * 4 + 3];
      if (ax2 > X) ax2 = X;
      if (ay2 > Y) ay2 = Y;
      int k = bt[b] - 2;
      int dx = mv[k * 2 + 0], dy = mv[k * 2 + 1];
      uint32_t* dst = scratch.data() + m * 256;
      for (int y = ay1; y < ay2; y++) {
        int sy = (y + dy) % Y;
        if (sy < 0) sy += Y;
        const uint32_t* src = plane + (size_t)sy * X;
        for (int x = ax1; x < ax2; x++) {
          int sx = (x + dx) % X;
          if (sx < 0) sx += X;
          *dst++ = src[sx];
        }
      }
    }
    // 3. paint: data rects from the pool, motion rects from the scratch
    size_t m = 0;
    for (int b = 0; b < NB; b++) {
      if (bt[b] == 0) continue;
      int bx = b % nbx, by = b / nbx;
      int ax1 = bx * 16 + rc[b * 4 + 0], ay1 = by * 16 + rc[b * 4 + 1];
      int ax2 = bx * 16 + rc[b * 4 + 2], ay2 = by * 16 + rc[b * 4 + 3];
      if (ax2 > X) ax2 = X;
      if (ay2 > Y) ay2 = Y;
      // hostile-but-parser-valid rects can give x1 > x2 (mutated
      // containers); clamp so the motion branch's src stride never
      // walks the scratch pointer out of bounds (numpy: empty slice)
      int w = ax2 - ax1;
      if (w < 0) w = 0;
      if (bt[b] == 1) {
        for (int y = ay1; y < ay2; y++)
          if (w > 0)
            memcpy(plane + (size_t)y * X + ax1, pool + (size_t)y * Xp + ax1,
                   (size_t)w * 4);
      } else {
        const uint32_t* src = scratch.data() + m++ * 256;
        for (int y = ay1; y < ay2; y++, src += w)
          if (w > 0) memcpy(plane + (size_t)y * X + ax1, src, (size_t)w * 4);
      }
    }
    // 4. restore the pool's zeros
    for (int64_t j = row_ptr[t]; j < row_ptr[t + 1]; j++)
      memset(pool + rows[j] * 128, 0, 128 * 4);
  }
  return 0;
}

}  // extern "C"
