/* refc_driver.c — ctypes-facing driver around the REFERENCE C sources.
 *
 * The reference implementation (pvachon/tsl-sdr) is compiled UNMODIFIED
 * from its tree (env TSL_REF_DIR, default /root/reference) against the
 * minimal TSL shim in shim/tsl.  This file only adapts its callback-style
 * APIs to flat buffers a ctypes caller can diff against the JAX framework:
 * it is the execution-level parity oracle (VERDICT r1 item 1) that replaces
 * trust in hand-transcribed numpy oracles.
 *
 * Entry points (all single-threaded; results serialized little-endian into
 * a caller buffer, return = bytes used or count, negative on error):
 *   refc_pocsag_run     pager/pager_pocsag.c  (messages via callbacks)
 *   refc_flex_run       pager/pager_flex.c    (alnum/num/siv callbacks)
 *   refc_ais_demod_run  ais/ais_demod.c       (raw HDLC packets)
 *   refc_ais_decode_run ais/ais_decode.c      (typed reports + armored raw)
 *   refc_bch_decode     pager/bch_code.c      (BCH(31,21,t=2))
 *   refc_direct_fir_run filter/direct_fir.c   (scalar build = the portable
 *                                              reference; SURVEY §2.1)
 *   refc_polyphase_run  filter/polyphase_fir.c
 *   refc_mm_run         pager/mueller_muller.c
 */

#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <tsl/result.h>
#include <tsl/errors.h>

#include <filter/sample_buf.h>
#include <filter/direct_fir.h>
#include <filter/polyphase_fir.h>
#include <pager/bch_code.h>
#include <pager/mueller_muller.h>
#include <pager/pager_flex.h>
#include <pager/pager_pocsag.h>
#include <ais/ais_decode.h>
#include <ais/ais_demod.h>

/* ---- result emit buffer (tests are single-threaded) -------------------- */

static uint8_t *g_out;
static size_t g_cap, g_len;
static int g_overflow;

static void emit(const void *p, size_t n)
{
    if (g_len + n <= g_cap)
        memcpy(g_out + g_len, p, n);
    else
        g_overflow = 1;
    g_len += n;
}

static void emit_u8(uint8_t v) { emit(&v, 1); }
static void emit_u16(uint16_t v) { emit(&v, 2); }
static void emit_u32(uint32_t v) { emit(&v, 4); }
static void emit_u64(uint64_t v) { emit(&v, 8); }

static void emit_begin(uint8_t *out, size_t cap)
{
    g_out = out;
    g_cap = cap;
    g_len = 0;
    g_overflow = 0;
}

static long emit_end(void) { return g_overflow ? -2 : (long)g_len; }

/* ---- sample_buf helper -------------------------------------------------- */

static aresult_t _buf_release(struct sample_buf *buf)
{
    free(buf);
    return A_OK;
}

static struct sample_buf *make_buf(const int16_t *vals, size_t nr_values,
                                   size_t nr_samples)
{
    size_t bytes = nr_values * sizeof(int16_t);
    struct sample_buf *b = calloc(1, sizeof(*b) + bytes);
    if (b == NULL) return NULL;
    b->refcount = 1;
    b->sample_type = COMPLEX_INT_16;
    b->nr_samples = (uint32_t)nr_samples;
    b->sample_buf_bytes = (uint32_t)bytes;
    b->release = _buf_release;
    memcpy(b->data_buf, vals, bytes);
    return b;
}

/* ---- POCSAG -------------------------------------------------------------
 * Record: tag('A'|'N') u16 baud u32 capcode u8 function u32 len bytes */

static aresult_t _pocsag_on_alpha(struct pager_pocsag *p, uint16_t baud,
                                  uint32_t capcode, const char *data,
                                  size_t len, uint8_t function)
{
    (void)p;
    emit_u8('A'); emit_u16(baud); emit_u32(capcode); emit_u8(function);
    emit_u32((uint32_t)len); emit(data, len);
    return A_OK;
}

static aresult_t _pocsag_on_numeric(struct pager_pocsag *p, uint16_t baud,
                                    uint32_t capcode, const char *data,
                                    size_t len, uint8_t function)
{
    (void)p;
    emit_u8('N'); emit_u16(baud); emit_u32(capcode); emit_u8(function);
    emit_u32((uint32_t)len); emit(data, len);
    return A_OK;
}

long refc_pocsag_run(const int16_t *pcm, size_t n, size_t block,
                     int skip_bch, uint8_t *out, size_t cap)
{
    struct pager_pocsag *p = NULL;
    emit_begin(out, cap);
    if (FAILED(pager_pocsag_new(&p, 929612500u, _pocsag_on_numeric,
                                _pocsag_on_alpha, skip_bch != 0)))
        return -1;
    for (size_t i = 0; i < n; i += block) {
        size_t take = n - i < block ? n - i : block;
        if (FAILED(pager_pocsag_on_pcm(p, pcm + i, take))) {
            pager_pocsag_delete(&p);
            return -1;
        }
    }
    pager_pocsag_delete(&p);
    return emit_end();
}

/* ---- FLEX ---------------------------------------------------------------
 * alnum: 'L' u16 baud u8 phase u8 cyc u8 frame u64 cap u8 frag u8 maildrop
 *        u8 seq u32 len bytes
 * num:   'U' u16 baud u8 phase u8 cyc u8 frame u64 cap u32 len bytes
 * siv:   'S' u16 baud u8 phase u8 cyc u8 frame u64 cap u8 type u32 data */

static aresult_t _flex_on_alnum(struct pager_flex *f, uint16_t baud,
                                uint8_t phase, uint8_t cyc, uint8_t frame,
                                uint64_t cap_code, bool frag, bool maildrop,
                                uint8_t seq, const char *msg, size_t len)
{
    (void)f;
    emit_u8('L'); emit_u16(baud); emit_u8(phase); emit_u8(cyc);
    emit_u8(frame); emit_u64(cap_code); emit_u8(frag); emit_u8(maildrop);
    emit_u8(seq); emit_u32((uint32_t)len); emit(msg, len);
    return A_OK;
}

static aresult_t _flex_on_num(struct pager_flex *f, uint16_t baud,
                              uint8_t phase, uint8_t cyc, uint8_t frame,
                              uint64_t cap_code, const char *msg, size_t len)
{
    (void)f;
    emit_u8('U'); emit_u16(baud); emit_u8(phase); emit_u8(cyc);
    emit_u8(frame); emit_u64(cap_code);
    emit_u32((uint32_t)len); emit(msg, len);
    return A_OK;
}

static aresult_t _flex_on_siv(struct pager_flex *f, uint16_t baud,
                              uint8_t phase, uint8_t cyc, uint8_t frame,
                              uint64_t cap_code, uint8_t siv_type,
                              uint32_t data)
{
    (void)f;
    emit_u8('S'); emit_u16(baud); emit_u8(phase); emit_u8(cyc);
    emit_u8(frame); emit_u64(cap_code); emit_u8(siv_type); emit_u32(data);
    return A_OK;
}

long refc_flex_run(const int16_t *pcm, size_t n, size_t block,
                   uint8_t *out, size_t cap)
{
    struct pager_flex *f = NULL;
    emit_begin(out, cap);
    if (FAILED(pager_flex_new(&f, 929612500u, _flex_on_alnum, _flex_on_num,
                              _flex_on_siv)))
        return -1;
    for (size_t i = 0; i < n; i += block) {
        size_t take = n - i < block ? n - i : block;
        if (FAILED(pager_flex_on_pcm(f, pcm + i, take))) {
            pager_flex_delete(&f);
            return -1;
        }
    }
    pager_flex_delete(&f);
    return emit_end();
}

/* ---- AIS ----------------------------------------------------------------
 * demod packet: 'P' u8 fcs_valid u32 len bytes
 * decode report: tag('R'|'B'|'V') u32 mmsi u32 rawlen rawbytes */

static aresult_t _ais_demod_on_msg(struct ais_demod *d, void *state,
                                   const uint8_t *packet, size_t len,
                                   bool fcs_valid)
{
    (void)d; (void)state;
    emit_u8('P'); emit_u8(fcs_valid); emit_u32((uint32_t)len);
    emit(packet, len);
    return A_OK;
}

long refc_ais_demod_run(const int16_t *pcm, size_t n, size_t block,
                        uint8_t *out, size_t cap)
{
    struct ais_demod *d = NULL;
    emit_begin(out, cap);
    if (FAILED(ais_demod_new(&d, NULL, _ais_demod_on_msg, 161975000u)))
        return -1;
    for (size_t i = 0; i < n; i += block) {
        size_t take = n - i < block ? n - i : block;
        if (FAILED(ais_demod_on_pcm(d, pcm + i, take))) {
            ais_demod_delete(&d);
            return -1;
        }
    }
    ais_demod_delete(&d);
    return emit_end();
}

static void _emit_raw(uint8_t tag, uint32_t mmsi, const char *raw)
{
    size_t len = raw ? strlen(raw) : 0;
    emit_u8(tag); emit_u32(mmsi); emit_u32((uint32_t)len); emit(raw, len);
}

static aresult_t _ais_on_position(struct ais_decode *d, void *state,
                                  struct ais_position_report *rpt,
                                  const char *raw)
{
    (void)d; (void)state;
    _emit_raw('R', rpt->mmsi, raw);
    emit_u32(rpt->nav_stat); emit_u32(rpt->course); emit_u32(rpt->heading);
    emit_u32(rpt->timestamp);
    emit(&rpt->longitude, 4); emit(&rpt->latitude, 4);
    emit(&rpt->speed_over_ground, 4);
    return A_OK;
}

static aresult_t _ais_on_base(struct ais_decode *d, void *state,
                              struct ais_base_station_report *bsr,
                              const char *raw)
{
    (void)d; (void)state;
    _emit_raw('B', bsr->mmsi, raw);
    emit_u32(bsr->year); emit_u32(bsr->month); emit_u32(bsr->day);
    emit_u32(bsr->hour); emit_u32(bsr->minute); emit_u32(bsr->second);
    emit(&bsr->longitude, 4); emit(&bsr->latitude, 4);
    return A_OK;
}

static aresult_t _ais_on_voyage(struct ais_decode *d, void *state,
                                struct ais_static_voyage_data *svd,
                                const char *raw)
{
    (void)d; (void)state;
    _emit_raw('V', svd->mmsi, raw);
    emit_u32(svd->imo_number); emit_u32(svd->ship_type);
    emit(svd->callsign, 8); emit(svd->ship_name, 21);
    emit(svd->destination, 21);
    return A_OK;
}

long refc_ais_decode_run(const int16_t *pcm, size_t n, size_t block,
                         uint8_t *out, size_t cap)
{
    struct ais_decode *d = NULL;
    emit_begin(out, cap);
    if (FAILED(ais_decode_new(&d, 161975000u, _ais_on_position, _ais_on_base,
                              _ais_on_voyage)))
        return -1;
    for (size_t i = 0; i < n; i += block) {
        size_t take = n - i < block ? n - i : block;
        if (FAILED(ais_decode_on_pcm(d, pcm + i, take))) {
            ais_decode_delete(&d);
            return -1;
        }
    }
    ais_decode_delete(&d);
    return emit_end();
}

/* ---- BCH(31,21,t=2) ----------------------------------------------------- */

long refc_bch_decode(const uint32_t *words, size_t n, uint32_t *corrected,
                     int32_t *rc)
{
    /* the pagers' instantiation: p(x)=x^5+x^2+1, (m,n,k,t)=(5,31,21,2)
     * (pager/pager_pocsag.c:150, pager/pager_flex.c:1353) */
    static const int poly[6] = {1, 0, 1, 0, 0, 1};
    struct bch_code *bch = NULL;
    if (FAILED(bch_code_new(&bch, poly, 5, 31, 21, 2)))
        return -1;
    for (size_t i = 0; i < n; i++) {
        uint32_t w = words[i];
        rc[i] = bch_code_decode(bch, &w);
        corrected[i] = w;
    }
    bch_code_delete(&bch);
    return (long)n;
}

/* ---- direct FIR (scalar reference path) --------------------------------- */

long refc_direct_fir_run(const int16_t *taps_re, const int16_t *taps_im,
                         size_t ntaps, unsigned decim, int derotate,
                         uint32_t fs, int32_t freq_shift,
                         const int16_t *iq, size_t nr_iq_samples,
                         size_t buf_samples, int16_t *out_iq,
                         size_t out_cap_samples)
{
    struct direct_fir fir;
    size_t produced = 0;
    memset(&fir, 0, sizeof(fir));
    if (FAILED(direct_fir_init(&fir, ntaps, taps_re, taps_im, decim,
                               derotate != 0, fs, freq_shift)))
        return -1;

    size_t fed = 0;
    for (;;) {
        bool can = false;
        size_t est = 0;
        /* drain everything available */
        if (FAILED(direct_fir_can_process(&fir, &can, &est)))
            goto fail;
        while (can) {
            size_t got = 0;
            size_t room = out_cap_samples - produced;
            if (room == 0) goto fail;
            if (FAILED(direct_fir_process(&fir, out_iq + 2 * produced,
                                          room, &got)))
                goto fail;
            produced += got;
            if (got == 0) break;
            if (FAILED(direct_fir_can_process(&fir, &can, &est)))
                goto fail;
        }
        if (fed >= nr_iq_samples)
            break;
        bool full = true;
        if (FAILED(direct_fir_full(&fir, &full)))
            goto fail;
        if (full)
            goto fail; /* drained above; a full FIR here means no progress */
        size_t take = nr_iq_samples - fed < buf_samples
                          ? nr_iq_samples - fed : buf_samples;
        struct sample_buf *b = make_buf(iq + 2 * fed, 2 * take, take);
        if (b == NULL) goto fail;
        if (FAILED(direct_fir_push_sample_buf(&fir, b))) {
            sample_buf_decref(b);
            goto fail;
        }
        fed += take;
    }
    direct_fir_cleanup(&fir);
    return (long)produced;
fail:
    direct_fir_cleanup(&fir);
    return -1;
}

/* ---- polyphase resampler ------------------------------------------------ */

long refc_polyphase_run(const int16_t *taps, size_t ntaps, unsigned interp,
                        unsigned decim, const int16_t *pcm, size_t n,
                        size_t buf_samples, int16_t *out, size_t out_cap)
{
    struct polyphase_fir *fir = NULL;
    size_t produced = 0;
    if (FAILED(polyphase_fir_new(&fir, ntaps, taps, interp, decim)))
        return -1;
    size_t fed = 0;
    for (;;) {
        bool can = false;
        if (FAILED(polyphase_fir_can_process(fir, &can)))
            goto fail;
        while (can) {
            size_t got = 0;
            size_t room = out_cap - produced;
            if (room == 0) goto fail;
            if (FAILED(polyphase_fir_process(fir, out + produced, room, &got)))
                goto fail;
            produced += got;
            if (got == 0) break;
            if (FAILED(polyphase_fir_can_process(fir, &can)))
                goto fail;
        }
        if (fed >= n)
            break;
        bool full = true;
        if (FAILED(polyphase_fir_full(fir, &full)))
            goto fail;
        if (full)
            goto fail;
        size_t take = n - fed < buf_samples ? n - fed : buf_samples;
        struct sample_buf *b = make_buf(pcm + fed, take, take);
        if (b == NULL) goto fail;
        if (FAILED(polyphase_fir_push_sample_buf(fir, b))) {
            sample_buf_decref(b);
            goto fail;
        }
        fed += take;
    }
    polyphase_fir_delete(&fir);
    return (long)produced;
fail:
    polyphase_fir_delete(&fir);
    return -1;
}

/* ---- FM quadrature discriminator ---------------------------------------- */

#include <multifm/fm_demod.h>

long refc_fm_demod_run(const int16_t *iq, size_t nr_samples, size_t block,
                       int16_t *out, size_t cap)
{
    struct demod_base *d = NULL;
    size_t total = 0;
    if (FAILED(multifm_fm_demod_init(&d)))
        return -1;
    for (size_t i = 0; i < nr_samples; i += block) {
        size_t take = nr_samples - i < block ? nr_samples - i : block;
        size_t got = 0, bytes = 0;
        if (cap - total < take) {
            multifm_fm_demod_cleanup(&d);
            return -2;
        }
        if (FAILED(multifm_fm_demod_process(d, (int16_t *)(iq + 2 * i), take,
                                            out + total, &got, &bytes))) {
            multifm_fm_demod_cleanup(&d);
            return -1;
        }
        total += got;
    }
    multifm_fm_demod_cleanup(&d);
    return (long)total;
}

/* ---- DC blocker (header-only in the reference) -------------------------- */

#include <filter/dc_blocker.h>

long refc_dc_blocker_run(double pole, const int16_t *in, size_t n,
                         int16_t *out) {
    struct dc_blocker blk;
    if (FAILED(dc_blocker_init(&blk, pole))) return -1;
    memcpy(out, in, n * sizeof(int16_t));
    if (FAILED(dc_blocker_apply(&blk, out, n))) return -1;
    return (long)n;
}

/* ---- Mueller-Müller clock recovery -------------------------------------- */

long refc_mm_run(float kw, float km, float samples_per_bit, float error_min,
                 float error_max, const int16_t *pcm, size_t n, size_t block,
                 int16_t *decisions, size_t cap)
{
    struct mueller_muller mm;
    size_t total = 0;
    if (FAILED(mm_init(&mm, kw, km, samples_per_bit, error_min, error_max)))
        return -1;
    for (size_t i = 0; i < n; i += block) {
        size_t take = n - i < block ? n - i : block;
        size_t got = 0;
        if (cap - total < take / (size_t)samples_per_bit + 2)
            return -2;
        if (FAILED(mm_process(&mm, pcm + i, take, decisions + total,
                              cap - total, &got)))
            return -1;
        total += got;
    }
    return (long)total;
}
