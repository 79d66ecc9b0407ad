// Native host-side IO for raytracer_tpu: OBJ parsing and ASCII-PPM codec.
//
// The reference implements its entire host runtime in native code (Rust);
// here the compute path is JAX/XLA/Pallas and the host-side
// throughput paths — parsing multi-megabyte OBJ meshes and encoding
// megapixel ASCII PPMs — are C++ behind a ctypes ABI
// (raytracer_tpu/native.py), with pure-Python fallbacks.
//
// Layout contract (see native.py):
//   parse_obj two-pass: obj_count() sizes, obj_fill() writes flat arrays.
//   Faces are fan-triangulated like the reference's wavefront crate
//   (/root/reference/src/obj.rs:8-41); g/o lines split groups; negative
//   indices are end-relative.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct ObjCounts {
  int64_t n_vertices;
  int64_t n_normals;
  int64_t n_tris;
  int64_t n_groups;
};

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// counts vertices/normals/triangles(after fan-triangulation)/groups
int obj_count(const char* text, int64_t len, ObjCounts* out) {
  const char* p = text;
  const char* end = text + len;
  int64_t nv = 0, nn = 0, nt = 0, ng = 0;
  bool group_open = false;
  int64_t tris_in_group = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      ++nv;
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      ++nn;
    } else if (p + 1 < end && (p[0] == 'g' || p[0] == 'o') &&
               (p[1] == ' ' || p[1] == '\t' || p[1] == '\n' || p[1] == '\r')) {
      if (tris_in_group > 0) { ++ng; tris_in_group = 0; }
      group_open = true;
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      // count corners
      int corners = 0;
      const char* q = p + 1;
      while (q < end && *q != '\n') {
        q = skip_ws(q, end);
        if (q < end && *q != '\n' && *q != '\r') {
          ++corners;
          while (q < end && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r')
            ++q;
        } else break;
      }
      if (corners >= 3) { nt += corners - 2; tris_in_group += corners - 2; }
      (void)group_open;
    }
    p = next_line(p, end);
  }
  if (tris_in_group > 0) ++ng;
  out->n_vertices = nv;
  out->n_normals = nn;
  out->n_tris = nt;
  out->n_groups = ng;
  return 0;
}

static inline const char* parse_f32(const char* p, const char* end, float* out) {
  char* e = nullptr;
  *out = strtof(p, &e);
  return (e && e <= end) ? e : p;
}

static inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  char* e = nullptr;
  *out = strtoll(p, &e, 10);
  return (e && e <= end) ? e : p;
}

// Fills:
//   verts   [n_vertices*3] f32
//   norms   [n_normals*3]  f32
//   tri_v   [n_tris*3]     i64  vertex index per corner (0-based)
//   tri_n   [n_tris*3]     i64  normal index per corner (-1 = none)
//   tri_grp [n_tris]       i64  group ordinal per triangle
int obj_fill(const char* text, int64_t len, float* verts, float* norms,
             int64_t* tri_v, int64_t* tri_n, int64_t* tri_grp) {
  const char* p = text;
  const char* end = text + len;
  int64_t vi = 0, ni = 0, ti = 0;
  int64_t group = 0;
  bool group_has_tris = false;

  // Dynamic corner buffers: obj_count() sizes the output for ALL corners of
  // a polygon face, so obj_fill must triangulate them all too (a fixed cap
  // here would leave trailing output rows uninitialized).
  std::vector<int64_t> corner_v;
  std::vector<int64_t> corner_n;

  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 1;
      for (int k = 0; k < 3; ++k) {
        q = skip_ws(q, end);
        q = parse_f32(q, end, &verts[vi * 3 + k]);
      }
      ++vi;
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      const char* q = p + 2;
      for (int k = 0; k < 3; ++k) {
        q = skip_ws(q, end);
        q = parse_f32(q, end, &norms[ni * 3 + k]);
      }
      ++ni;
    } else if (p + 1 < end && (p[0] == 'g' || p[0] == 'o') &&
               (p[1] == ' ' || p[1] == '\t' || p[1] == '\n' || p[1] == '\r')) {
      if (group_has_tris) { ++group; group_has_tris = false; }
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 1;
      corner_v.clear();
      corner_n.clear();
      while (q < end && *q != '\n') {
        q = skip_ws(q, end);
        if (q >= end || *q == '\n' || *q == '\r') break;
        int64_t v = 0, n = -1;
        q = parse_i64(q, end, &v);
        if (q < end && *q == '/') {
          ++q;                                     // maybe vt
          if (q < end && *q != '/') { int64_t vt; q = parse_i64(q, end, &vt); }
          if (q < end && *q == '/') { ++q; q = parse_i64(q, end, &n); }
        }
        corner_v.push_back(v > 0 ? v - 1 : vi + v);
        corner_n.push_back(n == -1 ? -1 : (n > 0 ? n - 1 : ni + n));
        while (q < end && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r')
          ++q;
      }
      int64_t corners = (int64_t)corner_v.size();
      for (int64_t k = 1; k + 1 < corners; ++k) {
        tri_v[ti * 3 + 0] = corner_v[0];
        tri_v[ti * 3 + 1] = corner_v[k];
        tri_v[ti * 3 + 2] = corner_v[k + 1];
        tri_n[ti * 3 + 0] = corner_n[0];
        tri_n[ti * 3 + 1] = corner_n[k];
        tri_n[ti * 3 + 2] = corner_n[k + 1];
        tri_grp[ti] = group;
        ++ti;
        group_has_tris = true;
      }
    }
    p = next_line(p, end);
  }
  return 0;
}

// u8 pixels -> ASCII P3 body ("r g b r g b ...", 15 samples per line).
// Returns bytes written. Caller sizes buf as n_samples * 4 + 16.
int64_t ppm_encode_ascii(const uint8_t* px, int64_t n_samples, char* buf) {
  char* w = buf;
  for (int64_t i = 0; i < n_samples; ++i) {
    uint32_t v = px[i];
    if (v >= 100) {
      *w++ = '0' + v / 100;
      *w++ = '0' + (v / 10) % 10;
      *w++ = '0' + v % 10;
    } else if (v >= 10) {
      *w++ = '0' + v / 10;
      *w++ = '0' + v % 10;
    } else {
      *w++ = '0' + v;
    }
    *w++ = (i % 15 == 14) ? '\n' : ' ';
  }
  if (n_samples && w[-1] == ' ') w[-1] = '\n';
  return w - buf;
}

// ASCII P3 body -> u8 samples; returns count parsed (comments stripped by caller).
int64_t ppm_decode_ascii(const char* text, int64_t len, uint16_t* out,
                         int64_t max_samples) {
  const char* p = text;
  const char* end = text + len;
  int64_t n = 0;
  while (p < end && n < max_samples) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    if (*p == '#') { p = next_line(p, end); continue; }
    uint32_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    out[n++] = (uint16_t)v;
  }
  return n;
}

}  // extern "C"
