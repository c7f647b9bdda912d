// Native OBJ parser for realtrace_tpu_torch (ctypes C ABI).
//
// The data-loader component of the runtime: the v/vn/vt/f subset with
// '/'-separated face indices, the same surface the reference parses in
// Serial/lumina.cpp:234-287 and Parellel/main.cu:155-199 — rebuilt as a
// single-pass buffered scanner (~50x the Python parser's throughput on
// large meshes). Python binds via ctypes (realtrace_tpu_torch/io/native_obj.py).
//
// Semantics notes vs the reference:
//  * indices are converted 1-based -> 0-based for BOTH vertex and texture
//    ids (the reference forgets the -1 on texture ids, Serial/lumina.cpp:248);
//  * negative (relative) OBJ indices are resolved against the current count;
//  * only the first three corners of a face are used (triangles), as in the
//    reference loaders.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> v;    // xyz triples
  std::vector<double> vn;   // xyz triples
  std::vector<double> vt;   // uv pairs
  std::vector<int32_t> fv;  // 3 vertex ids per face
  std::vector<int32_t> ft;  // 3 texture ids per face (-1 = none)
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* skip_token(const char* p) {
  while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  return p;
}

// parse "i", "i/j", "i//k", "i/j/k"; returns ptr past token
const char* parse_corner(const char* p, long nv, long nvt, int32_t* vid, int32_t* tid) {
  char* end = nullptr;
  long i = strtol(p, &end, 10);
  *vid = (int32_t)(i > 0 ? i - 1 : nv + i);
  *tid = -1;
  p = end;
  if (*p == '/') {
    ++p;
    if (*p != '/' && *p && *p != ' ' && *p != '\n') {
      long j = strtol(p, &end, 10);
      *tid = (int32_t)(j > 0 ? j - 1 : nvt + j);
      p = end;
    }
    if (*p == '/') {  // normal id: parsed and discarded (parity: unused in shading)
      ++p;
      strtol(p, &end, 10);
      p = end;
    }
  }
  return p;
}

}  // namespace

extern "C" {

void* rt_obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new ObjData();
  d->v.reserve(1 << 15);
  d->fv.reserve(1 << 15);
  char line[8192];
  while (fgets(line, sizeof line, f)) {
    const char* p = skip_ws(line);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* end = nullptr;
      double x = strtod(p + 2, &end), y = strtod(end, &end), z = strtod(end, &end);
      d->v.push_back(x); d->v.push_back(y); d->v.push_back(z);
    } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
      char* end = nullptr;
      double x = strtod(p + 3, &end), y = strtod(end, &end), z = strtod(end, &end);
      d->vn.push_back(x); d->vn.push_back(y); d->vn.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) {
      char* end = nullptr;
      double u = strtod(p + 3, &end), w = strtod(end, &end);
      d->vt.push_back(u); d->vt.push_back(w);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const long nv = (long)(d->v.size() / 3), nvt = (long)(d->vt.size() / 2);
      p = skip_ws(p + 1);
      int32_t vid[3], tid[3];
      bool ok = true;
      for (int k = 0; k < 3 && ok; ++k) {
        if (!*p || *p == '\n') { ok = false; break; }
        p = parse_corner(p, nv, nvt, &vid[k], &tid[k]);
        p = skip_ws(skip_token(p));
      }
      if (ok) {
        for (int k = 0; k < 3; ++k) { d->fv.push_back(vid[k]); d->ft.push_back(tid[k]); }
      }
    }
    // comments / unknown tags: skipped (fgets consumed the line)
  }
  fclose(f);
  return d;
}

void rt_obj_counts(void* h, int64_t* nv, int64_t* nvn, int64_t* nvt, int64_t* nf) {
  auto* d = static_cast<ObjData*>(h);
  *nv = (int64_t)(d->v.size() / 3);
  *nvn = (int64_t)(d->vn.size() / 3);
  *nvt = (int64_t)(d->vt.size() / 2);
  *nf = (int64_t)(d->fv.size() / 3);
}

void rt_obj_copy(void* h, double* v, double* vn, double* vt, int32_t* fv, int32_t* ft) {
  auto* d = static_cast<ObjData*>(h);
  if (v && !d->v.empty()) memcpy(v, d->v.data(), d->v.size() * sizeof(double));
  if (vn && !d->vn.empty()) memcpy(vn, d->vn.data(), d->vn.size() * sizeof(double));
  if (vt && !d->vt.empty()) memcpy(vt, d->vt.data(), d->vt.size() * sizeof(double));
  if (fv && !d->fv.empty()) memcpy(fv, d->fv.data(), d->fv.size() * sizeof(int32_t));
  if (ft && !d->ft.empty()) memcpy(ft, d->ft.data(), d->ft.size() * sizeof(int32_t));
}

void rt_obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
