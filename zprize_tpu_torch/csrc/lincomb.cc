// Host G1 linear combination for the verifier: out = sum_i k_i * P_i over
// affine points of a short-Weierstrass curve y^2 = x^3 + b (a = 0) with a
// base field of at most 384 bits.  Built with the host C++ compiler (not
// nvcc) by utils/build.py; called through ctypes by pcs/lincomb.py.
//
// Interleaved multi-exponentiation: one shared chain of 256 doublings, and
// one add of P_i per set bit of k_i, on the complete projective formulas
// of Renes-Costello-Batina for a = 0 (eprint 2015/1060, Algorithm 7; the
// formulas of curve/sw.py and csrc/msm_sw.cu), in 6 x 64-bit Montgomery
// words (CIOS product with unsigned __int128).  One Fermat inversion maps
// the sum to affine.
//
// Interface: every field element is 6 little-endian u64 words in standard
// (not Montgomery) form; a point is x[6] y[6], all zero for the identity;
// a scalar is 4 little-endian u64 words (below 2^256).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef unsigned __int128 u128;
typedef uint64_t u64;

constexpr int NL = 6;

struct Field {
  u64 p[NL];
  u64 rr[NL];   // R^2 mod p, R = 2^384
  u64 one[NL];  // R mod p
  u64 n0;       // -p^-1 mod 2^64
};

bool geq(const u64* a, const u64* b) {
  for (int i = NL - 1; i >= 0; --i)
    if (a[i] != b[i]) return a[i] > b[i];
  return true;
}

// out = a - b, returning the borrow
u64 sub_words(u64* out, const u64* a, const u64* b) {
  u64 borrow = 0;
  for (int i = 0; i < NL; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    out[i] = (u64)d;
    borrow = (u64)(d >> 64) & 1;
  }
  return borrow;
}

void add_mod(u64* out, const u64* a, const u64* b, const Field& f) {
  u64 t[NL];
  u64 carry = 0;
  for (int i = 0; i < NL; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    t[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  if (carry || geq(t, f.p))
    sub_words(out, t, f.p);
  else
    std::memcpy(out, t, sizeof(t));
}

void sub_mod(u64* out, const u64* a, const u64* b, const Field& f) {
  u64 t[NL];
  if (sub_words(t, a, b)) {
    u64 carry = 0;
    for (int i = 0; i < NL; ++i) {
      u128 s = (u128)t[i] + f.p[i] + carry;
      t[i] = (u64)s;
      carry = (u64)(s >> 64);
    }
  }
  std::memcpy(out, t, sizeof(t));
}

void mul_mod(u64* out, const u64* a, const u64* b, const Field& f) {
  u64 t[NL + 2] = {0};
  for (int i = 0; i < NL; ++i) {
    u64 carry = 0;
    for (int j = 0; j < NL; ++j) {
      u128 s = (u128)t[j] + (u128)a[i] * b[j] + carry;
      t[j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    u128 s = (u128)t[NL] + carry;
    t[NL] = (u64)s;
    t[NL + 1] = (u64)(s >> 64);
    u64 m = t[0] * f.n0;
    carry = (u64)(((u128)t[0] + (u128)m * f.p[0]) >> 64);
    for (int j = 1; j < NL; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * f.p[j] + carry;
      t[j - 1] = (u64)s2;
      carry = (u64)(s2 >> 64);
    }
    s = (u128)t[NL] + carry;
    t[NL - 1] = (u64)s;
    t[NL] = t[NL + 1] + (u64)(s >> 64);
  }
  if (t[NL] || geq(t, f.p))
    sub_words(out, t, f.p);
  else
    std::memcpy(out, t, NL * sizeof(u64));
}

bool is_zero(const u64* a) {
  for (int i = 0; i < NL; ++i)
    if (a[i]) return false;
  return true;
}

void make_field(Field& f, const u64* p) {
  std::memcpy(f.p, p, sizeof(f.p));
  u64 inv = p[0];  // p^-1 mod 2^64 by Newton's iteration (p odd)
  for (int i = 0; i < 6; ++i) inv *= 2 - p[0] * inv;
  f.n0 = 0 - inv;
  u64 acc[NL] = {1, 0, 0, 0, 0, 0};
  for (int i = 0; i < 64 * NL; ++i) add_mod(acc, acc, acc, f);
  std::memcpy(f.one, acc, sizeof(acc));
  for (int i = 0; i < 64 * NL; ++i) add_mod(acc, acc, acc, f);
  std::memcpy(f.rr, acc, sizeof(acc));
}

void to_mont(u64* out, const u64* a, const Field& f) { mul_mod(out, a, f.rr, f); }

void from_mont(u64* out, const u64* a, const Field& f) {
  const u64 one[NL] = {1, 0, 0, 0, 0, 0};
  mul_mod(out, a, one, f);
}

// a^(p-2): Fermat inverse (0 -> 0)
void inv_mod(u64* out, const u64* a, const Field& f) {
  const u64 two[NL] = {2, 0, 0, 0, 0, 0};
  u64 e[NL], acc[NL], base[NL];
  sub_words(e, f.p, two);
  std::memcpy(acc, f.one, sizeof(acc));
  std::memcpy(base, a, sizeof(base));
  for (int i = 0; i < 64 * NL; ++i) {
    if ((e[i / 64] >> (i % 64)) & 1) mul_mod(acc, acc, base, f);
    mul_mod(base, base, base, f);
  }
  std::memcpy(out, acc, sizeof(acc));
}

struct Point {
  u64 x[NL], y[NL], z[NL];
};

// complete projective addition for a = 0 (RCB Algorithm 7); r may alias
// p or q
void add(Point& r, const Point& p, const Point& q, const u64* b3,
         const Field& f) {
  u64 t0[NL], t1[NL], t2[NL], t3[NL], t4[NL], u[NL], v[NL], w[NL];
  u64 mxy[NL], myz[NL], mxz[NL], s[NL], s2[NL], a1[NL], a2[NL];
  mul_mod(t0, p.x, q.x, f);
  mul_mod(t1, p.y, q.y, f);
  mul_mod(t2, p.z, q.z, f);
  add_mod(a1, p.x, p.y, f);
  add_mod(a2, q.x, q.y, f);
  mul_mod(mxy, a1, a2, f);
  add_mod(s, t0, t1, f);
  sub_mod(mxy, mxy, s, f);
  add_mod(a1, p.y, p.z, f);
  add_mod(a2, q.y, q.z, f);
  mul_mod(myz, a1, a2, f);
  add_mod(s, t1, t2, f);
  sub_mod(myz, myz, s, f);
  add_mod(a1, p.x, p.z, f);
  add_mod(a2, q.x, q.z, f);
  mul_mod(mxz, a1, a2, f);
  add_mod(s, t0, t2, f);
  sub_mod(mxz, mxz, s, f);
  mul_mod(t4, b3, t2, f);
  sub_mod(u, t1, t4, f);
  add_mod(v, t1, t4, f);
  mul_mod(w, b3, mxz, f);
  add_mod(t3, t0, t0, f);
  add_mod(t3, t3, t0, f);
  Point o;
  mul_mod(s, mxy, u, f);
  mul_mod(s2, myz, w, f);
  sub_mod(o.x, s, s2, f);
  mul_mod(s, v, u, f);
  mul_mod(s2, t3, w, f);
  add_mod(o.y, s, s2, f);
  mul_mod(s, myz, v, f);
  mul_mod(s2, mxy, t3, f);
  add_mod(o.z, s, s2, f);
  r = o;
}

}  // namespace

extern "C" {

// out (x[6], y[6]) = sum_{i < n} k_i * P_i; p_words: the base field's
// modulus; b3_words: 3b of the curve.
void lincomb(const u64* p_words, const u64* b3_words, const u64* pts_xy,
             const u64* ks4, u64 n, u64* out) {
  Field f;
  make_field(f, p_words);
  u64 b3[NL];
  to_mont(b3, b3_words, f);
  std::vector<Point> pts(n);
  std::vector<char> live(n, 0);
  for (u64 i = 0; i < n; ++i) {
    const u64* xy = pts_xy + 12 * i;
    for (int j = 0; j < 12; ++j)
      if (xy[j]) live[i] = 1;
    if (!live[i]) continue;
    to_mont(pts[i].x, xy, f);
    to_mont(pts[i].y, xy + NL, f);
    std::memcpy(pts[i].z, f.one, sizeof(f.one));
  }
  Point acc;
  std::memset(&acc, 0, sizeof(acc));
  std::memcpy(acc.y, f.one, sizeof(f.one));
  for (int bit = 255; bit >= 0; --bit) {
    add(acc, acc, acc, b3, f);
    for (u64 i = 0; i < n; ++i)
      if (live[i] && ((ks4[4 * i + bit / 64] >> (bit % 64)) & 1))
        add(acc, acc, pts[i], b3, f);
  }
  std::memset(out, 0, 12 * sizeof(u64));
  if (is_zero(acc.z)) return;
  u64 zi[NL], t[NL];
  inv_mod(zi, acc.z, f);
  mul_mod(t, acc.x, zi, f);
  from_mont(out, t, f);
  mul_mod(t, acc.y, zi, f);
  from_mont(out + NL, t, f);
}

}  // extern "C"
