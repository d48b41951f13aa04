/*
 * CPU baseline for the flagship path: N-channel channelize + FM demod.
 *
 * Implements the same per-output arithmetic as the reference's scalar build
 * (complex int16 MAC FIR with decimation + Q.14 derotation, then conjugate
 * product + LUT atan2 discriminator) as a straight-line single-thread C
 * program, so the JAX framework's throughput can be compared against the
 * reference design point on this host. Written fresh against the numeric
 * contract in SURVEY.md section 2.1; not a copy of the reference sources.
 *
 * Build: g++ -O2 -march=native -o cpu_baseline cpu_baseline.c -lm
 * Usage: cpu_baseline [nr_channels] [nr_taps] [decimation] [nr_samples]
 * Output: one line: "<Msamples/s wideband input per second>"
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define Q14 14

static inline int16_t round_q28_q14(int32_t a) {
    return (int16_t)((a >> Q14) + ((a >> (Q14 - 1)) & 1));
}

static float atan_tab[257];

static void build_atan_table(void) {
    for (int i = 0; i < 256; i++) atan_tab[i] = (float)atan((double)i / 255.0);
    atan_tab[256] = atan_tab[255];
}

static float lut_atan2(float y, float x) {
    float ya = fabsf(y), xa = fabsf(x);
    if (!(ya > 0.0f || xa > 0.0f)) return 0.0f;
    float z = ya < xa ? ya / xa : xa / ya;
    float base;
    if (z < 0.003921569f) {
        base = z;
    } else {
        float alpha = z * 255.0f;
        int idx = ((int)alpha) & 0xff;
        alpha -= (float)idx;
        base = atan_tab[idx] + (atan_tab[idx + 1] - atan_tab[idx]) * alpha;
    }
    float ang;
    if (xa > ya) ang = x >= 0 ? (y >= 0 ? base : -base)
                              : (y >= 0 ? (float)M_PI - base : base - (float)M_PI);
    else ang = y >= 0 ? (x >= 0 ? (float)M_PI_2 - base : (float)M_PI_2 + base)
                      : (x >= 0 ? base - (float)M_PI_2 : -(float)M_PI_2 - base);
    return ang;
}

int main(int argc, char **argv) {
    int nr_ch = argc > 1 ? atoi(argv[1]) : 8;
    int nr_taps = argc > 2 ? atoi(argv[2]) : 128;
    int decim = argc > 3 ? atoi(argv[3]) : 40;
    long nr_samp = argc > 4 ? atol(argv[4]) : 4000000;

    int16_t *x = malloc(sizeof(int16_t) * 2 * nr_samp);
    int16_t *cr = malloc(sizeof(int16_t) * nr_ch * nr_taps);
    int16_t *ci = malloc(sizeof(int16_t) * nr_ch * nr_taps);
    srand(42);
    for (long i = 0; i < 2 * nr_samp; i++) x[i] = (int16_t)(rand() % 16000 - 8000);
    for (int i = 0; i < nr_ch * nr_taps; i++) {
        cr[i] = (int16_t)(rand() % 8000 - 4000);
        ci[i] = (int16_t)(rand() % 8000 - 4000);
    }
    build_atan_table();

    /* per-channel rotator state */
    int32_t *rot_re = malloc(sizeof(int32_t) * nr_ch);
    int32_t *rot_im = malloc(sizeof(int32_t) * nr_ch);
    int32_t *inc_re = malloc(sizeof(int32_t) * nr_ch);
    int32_t *inc_im = malloc(sizeof(int32_t) * nr_ch);
    int32_t *last_re = calloc(nr_ch, sizeof(int32_t));
    int32_t *last_im = calloc(nr_ch, sizeof(int32_t));
    for (int c = 0; c < nr_ch; c++) {
        double w = -2.0 * M_PI * (double)(c + 1) * 0.03 * decim;
        rot_re[c] = 1 << Q14; rot_im[c] = 0;
        inc_re[c] = (int32_t)(cos(w) * (1 << Q14));
        inc_im[c] = (int32_t)(sin(w) * (1 << Q14));
    }

    long nr_out = (nr_samp - nr_taps) / decim;
    volatile int32_t sink = 0;

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int c = 0; c < nr_ch; c++) {
        const int16_t *tcr = cr + (size_t)c * nr_taps;
        const int16_t *tci = ci + (size_t)c * nr_taps;
        for (long k = 0; k < nr_out; k++) {
            const int16_t *s = x + 2 * (size_t)k * decim;
            int32_t acc_re = 0, acc_im = 0;
            for (int t = 0; t < nr_taps; t++) {
                int32_t sr = s[2 * t], si = s[2 * t + 1];
                int32_t crr = tcr[t], cii = tci[t];
                acc_re += crr * sr - cii * si;
                acc_im += crr * si + cii * sr;
            }
            /* derotate */
            int32_t a_re = round_q28_q14(acc_re), a_im = round_q28_q14(acc_im);
            int32_t d_re = a_re * rot_re[c] - a_im * rot_im[c];
            int32_t d_im = a_re * rot_im[c] + a_im * rot_re[c];
            int32_t nr_ = round_q28_q14(rot_re[c] * inc_re[c] - rot_im[c] * inc_im[c]);
            int32_t ni_ = round_q28_q14(rot_re[c] * inc_im[c] + rot_im[c] * inc_re[c]);
            rot_re[c] = nr_; rot_im[c] = ni_;
            int32_t o_re = round_q28_q14(d_re), o_im = round_q28_q14(d_im);
            /* FM discriminator */
            int32_t s_re = o_re * last_re[c] + o_im * last_im[c];
            int32_t s_im = o_im * last_re[c] - o_re * last_im[c];
            last_re[c] = o_re; last_im[c] = o_im;
            float phi = lut_atan2((float)s_im, (float)s_re);
            sink += (int16_t)((phi / (float)M_PI) * (float)(1 << Q14));
        }
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    /* wideband input samples processed (the channelizer consumes the stream
       once; all channels share it, like the reference's fan-out) */
    double msps = (double)nr_samp / dt / 1e6;
    printf("%.3f\n", msps);
    (void)sink;
    return 0;
}
