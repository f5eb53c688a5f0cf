// The port's host I/O library: a LAMMPS data-file parser (read_data.cpp)
// and the custom and xyz trajectory writers (dump_custom.cpp, dump_xyz.cpp),
// host C++ with a plain C ABI and no CUDA, consumed through ctypes by
// obmd_tpu_torch/io/native.py.
//
// The port's own copy of native/obmdio.cpp, symbol for symbol and format
// for format, so a file reads to the same arrays and a frame is written as
// the same bytes as through the JAX package's library.  One change: a
// Velocities line finds its atom's row through a table built once, where
// native/obmdio.cpp scans every row (the same row, the first holding the
// tag, in linear time).  Built at first use
// by obmd_tpu_torch/_build.py (g++ -O2 -fPIC -std=c++17 -shared) into
// obmd_tpu_torch/csrc/build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct DataFile {
  int64_t natoms = 0;
  int ntypes = 0;
  double boxlo[3] = {0, 0, 0};
  double boxhi[3] = {0, 0, 0};
  std::vector<double> masses;   // [ntypes]
  std::vector<double> x;        // [natoms*3]
  std::vector<double> v;        // [natoms*3]
  std::vector<double> q;        // [natoms]
  std::vector<int32_t> type;    // [natoms] 0-based
  std::vector<int32_t> tag;     // [natoms]
  std::vector<int32_t> mol;     // [natoms]
  std::vector<int64_t> bonds;      // [nbonds*2] atom-tag pairs
  std::vector<int64_t> angles;     // [nangles*4] (type, a1, a2, a3)
  std::vector<int64_t> dihedrals;  // [ndihedrals*5] (type, a1..a4)
  std::vector<int64_t> impropers;  // [nimpropers*5] (type, i1..i4), i2 =
                                   // center (improper_harmonic.cpp order)
  bool has_v = false, has_q = false, has_mol = false;
  std::string error;
};

// strip comment + leading/trailing whitespace
std::string clean(const std::string& line) {
  auto s = line.substr(0, line.find('#'));
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r\n");
  return s.substr(a, b - a + 1);
}

std::vector<std::string> tokens(const std::string& s) {
  std::vector<std::string> out;
  const char* p = s.c_str();
  while (*p) {
    while (*p == ' ' || *p == '\t') p++;
    if (!*p) break;
    const char* q = p;
    while (*q && *q != ' ' && *q != '\t') q++;
    out.emplace_back(p, q - p);
    p = q;
  }
  return out;
}

bool ends_with(const std::string& s, const char* suffix) {
  size_t n = strlen(suffix);
  return s.size() >= n && s.compare(s.size() - n, n, suffix) == 0;
}

// atom_style codes: 0 atomic, 1 charge, 2 molecular, 3 full
DataFile* parse_data(const char* path, int style) {
  auto* df = new DataFile();
  FILE* fp = fopen(path, "r");
  if (!fp) {
    df->error = "cannot open file";
    return df;
  }
  std::vector<std::string> lines;
  {
    char buf[65536];
    while (fgets(buf, sizeof buf, fp)) lines.emplace_back(buf);
    fclose(fp);
  }
  size_t i = 1;  // skip title
  // header
  for (; i < lines.size(); i++) {
    std::string s = clean(lines[i]);
    if (s.empty()) continue;
    if (s == "Masses" || s.rfind("Atoms", 0) == 0 || s == "Velocities")
      break;
    auto t = tokens(s);
    if (ends_with(s, " atoms")) df->natoms = atoll(t[0].c_str());
    else if (ends_with(s, " atom types")) df->ntypes = atoi(t[0].c_str());
    else if (ends_with(s, "xlo xhi")) {
      df->boxlo[0] = atof(t[0].c_str()); df->boxhi[0] = atof(t[1].c_str());
    } else if (ends_with(s, "ylo yhi")) {
      df->boxlo[1] = atof(t[0].c_str()); df->boxhi[1] = atof(t[1].c_str());
    } else if (ends_with(s, "zlo zhi")) {
      df->boxlo[2] = atof(t[0].c_str()); df->boxhi[2] = atof(t[1].c_str());
    }
  }
  df->masses.assign(std::max(df->ntypes, 1), 1.0);
  df->x.assign(df->natoms * 3, 0.0);
  df->v.assign(df->natoms * 3, 0.0);
  df->q.assign(df->natoms, 0.0);
  df->type.assign(df->natoms, 0);
  df->tag.assign(df->natoms, 0);
  df->mol.assign(df->natoms, 0);

  while (i < lines.size()) {
    std::string header = clean(lines[i]);
    i++;
    if (header.empty()) continue;
    while (i < lines.size() && clean(lines[i]).empty()) i++;
    if (header == "Masses") {
      for (int k = 0; k < df->ntypes && i < lines.size(); k++, i++) {
        auto t = tokens(clean(lines[i]));
        int ty = atoi(t[0].c_str());
        if (ty >= 1 && ty <= df->ntypes) df->masses[ty - 1] = atof(t[1].c_str());
      }
    } else if (header.rfind("Atoms", 0) == 0) {
      // column count per style: atomic 5, charge 6, molecular 6, full 7
      // (+ optional image flags).  A SHORT line means the file's format
      // does not match the declared atom_style — reading on would shift
      // every coordinate silently (read_data.cpp errors out the same
      // way: "Incorrect atom format in data file").
      const size_t need = (style == 0) ? 5 : (style == 3) ? 7 : 6;
      for (int64_t k = 0; k < df->natoms && i < lines.size(); k++, i++) {
        auto t = tokens(clean(lines[i]));
        if (t.size() < need) {
          df->error = "Atoms line has " + std::to_string(t.size()) +
                      " columns; declared atom_style expects " +
                      std::to_string(need) +
                      " (file format does not match atom_style)";
          return df;
        }
        size_t c = 0;
        df->tag[k] = atoi(t[c++].c_str());
        if (style == 2 || style == 3) {
          df->mol[k] = atoi(t[c++].c_str());
          df->has_mol = true;
        }
        df->type[k] = atoi(t[c++].c_str()) - 1;
        if (style == 1) { df->q[k] = atof(t[c++].c_str()); df->has_q = true; }
        if (style == 3) { df->q[k] = atof(t[c++].c_str()); df->has_q = true; }
        for (int d = 0; d < 3; d++) df->x[k * 3 + d] = atof(t[c++].c_str());
      }
    } else if (header == "Bonds") {
      while (i < lines.size()) {
        auto t = tokens(clean(lines[i]));
        if (t.size() < 4) break;
        df->bonds.push_back(atoll(t[2].c_str()));
        df->bonds.push_back(atoll(t[3].c_str()));
        i++;
      }
    } else if (header == "Angles") {
      while (i < lines.size()) {
        auto t = tokens(clean(lines[i]));
        if (t.size() < 5) break;
        for (int c = 1; c <= 4; c++)
          df->angles.push_back(atoll(t[c].c_str()));
        i++;
      }
    } else if (header == "Dihedrals") {
      while (i < lines.size()) {
        auto t = tokens(clean(lines[i]));
        if (t.size() < 6) break;
        for (int c = 1; c <= 5; c++)
          df->dihedrals.push_back(atoll(t[c].c_str()));
        i++;
      }
    } else if (header == "Impropers") {
      while (i < lines.size()) {
        auto t = tokens(clean(lines[i]));
        if (t.size() < 6) break;
        for (int c = 1; c <= 5; c++)
          df->impropers.push_back(atoll(t[c].c_str()));
        i++;
      }
    } else if (header == "Velocities") {
      df->has_v = true;
      // the first row holding each tag, built at the first id that is not
      // at row id - 1 (native/obmdio.cpp scans every row for each such id,
      // which is quadratic in the atoms of a file written in slot order)
      std::unordered_map<int32_t, int64_t> row_of;
      for (int64_t k = 0; k < df->natoms && i < lines.size(); k++, i++) {
        auto t = tokens(clean(lines[i]));
        int id = atoi(t[0].c_str());
        int64_t row = (id - 1 >= 0 && id - 1 < df->natoms &&
                       df->tag[id - 1] == id)
                          ? id - 1
                          : -1;
        if (row < 0) {
          if (row_of.empty()) {
            row_of.reserve(df->natoms);
            for (int64_t r = 0; r < df->natoms; r++)
              row_of.emplace(df->tag[r], r);  // keeps the first row
          }
          auto found = row_of.find(id);
          if (found != row_of.end()) row = found->second;
        }
        if (row >= 0)
          for (int d = 0; d < 3; d++)
            df->v[row * 3 + d] = atof(t[d + 1].c_str());
      }
    } else {
      while (i < lines.size() && !clean(lines[i]).empty()) i++;
    }
  }
  return df;
}

}  // namespace

extern "C" {

void* obmdio_read_data(const char* path, int style) {
  return parse_data(path, style);
}

const char* obmdio_error(void* h) {
  auto* df = static_cast<DataFile*>(h);
  return df->error.empty() ? nullptr : df->error.c_str();
}

int64_t obmdio_natoms(void* h) { return static_cast<DataFile*>(h)->natoms; }
int obmdio_ntypes(void* h) { return static_cast<DataFile*>(h)->ntypes; }
int obmdio_has_v(void* h) { return static_cast<DataFile*>(h)->has_v; }
int obmdio_has_q(void* h) { return static_cast<DataFile*>(h)->has_q; }
int obmdio_has_mol(void* h) { return static_cast<DataFile*>(h)->has_mol; }

void obmdio_box(void* h, double* lo, double* hi) {
  auto* df = static_cast<DataFile*>(h);
  memcpy(lo, df->boxlo, 3 * sizeof(double));
  memcpy(hi, df->boxhi, 3 * sizeof(double));
}

void obmdio_fill(void* h, double* x, double* v, double* q, int32_t* type,
                 int32_t* tag, int32_t* mol, double* masses) {
  auto* df = static_cast<DataFile*>(h);
  memcpy(x, df->x.data(), df->x.size() * sizeof(double));
  memcpy(v, df->v.data(), df->v.size() * sizeof(double));
  memcpy(q, df->q.data(), df->q.size() * sizeof(double));
  memcpy(type, df->type.data(), df->type.size() * sizeof(int32_t));
  memcpy(tag, df->tag.data(), df->tag.size() * sizeof(int32_t));
  memcpy(mol, df->mol.data(), df->mol.size() * sizeof(int32_t));
  memcpy(masses, df->masses.data(), df->masses.size() * sizeof(double));
}

int64_t obmdio_nbonds(void* h) {
  return static_cast<DataFile*>(h)->bonds.size() / 2;
}
int64_t obmdio_nangles(void* h) {
  return static_cast<DataFile*>(h)->angles.size() / 4;
}
int64_t obmdio_ndihedrals(void* h) {
  return static_cast<DataFile*>(h)->dihedrals.size() / 5;
}
int64_t obmdio_nimpropers(void* h) {
  return static_cast<DataFile*>(h)->impropers.size() / 5;
}

void obmdio_fill_topology(void* h, int64_t* bonds, int64_t* angles,
                          int64_t* dihedrals) {
  auto* df = static_cast<DataFile*>(h);
  if (bonds && !df->bonds.empty())
    memcpy(bonds, df->bonds.data(), df->bonds.size() * sizeof(int64_t));
  if (angles && !df->angles.empty())
    memcpy(angles, df->angles.data(), df->angles.size() * sizeof(int64_t));
  if (dihedrals && !df->dihedrals.empty())
    memcpy(dihedrals, df->dihedrals.data(),
           df->dihedrals.size() * sizeof(int64_t));
}

void obmdio_fill_impropers(void* h, int64_t* impropers) {
  auto* df = static_cast<DataFile*>(h);
  if (impropers && !df->impropers.empty())
    memcpy(impropers, df->impropers.data(),
           df->impropers.size() * sizeof(int64_t));
}

void obmdio_free(void* h) { delete static_cast<DataFile*>(h); }

// --- dump writers -------------------------------------------------------

int obmdio_write_dump_custom(const char* path, int append, int64_t step,
                             int64_t n, const double* boxlo,
                             const double* boxhi, const char* bflags,
                             const int32_t* tag, const int32_t* type,
                             const float* x, const float* vv,
                             const float* f) {
  FILE* fp = fopen(path, append ? "a" : "w");
  if (!fp) return -1;
  fprintf(fp, "ITEM: TIMESTEP\n%lld\n", (long long)step);
  fprintf(fp, "ITEM: NUMBER OF ATOMS\n%lld\n", (long long)n);
  fprintf(fp, "ITEM: BOX BOUNDS %s\n", bflags);
  for (int d = 0; d < 3; d++) fprintf(fp, "%.9g %.9g\n", boxlo[d], boxhi[d]);
  fprintf(fp, "ITEM: ATOMS id type x y z vx vy vz fx fy fz\n");
  for (int64_t k = 0; k < n; k++) {
    fprintf(fp, "%d %d %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n",
            tag[k], type[k] + 1, x[3 * k], x[3 * k + 1], x[3 * k + 2],
            vv[3 * k], vv[3 * k + 1], vv[3 * k + 2], f[3 * k], f[3 * k + 1],
            f[3 * k + 2]);
  }
  fclose(fp);
  return 0;
}

int obmdio_write_xyz(const char* path, int append, int64_t step, int64_t n,
                     const int32_t* type, const float* x) {
  FILE* fp = fopen(path, append ? "a" : "w");
  if (!fp) return -1;
  fprintf(fp, "%lld\nstep %lld\n", (long long)n, (long long)step);
  for (int64_t k = 0; k < n; k++)
    fprintf(fp, "%d %.6f %.6f %.6f\n", type[k] + 1, x[3 * k], x[3 * k + 1],
            x[3 * k + 2]);
  fclose(fp);
  return 0;
}

}  // extern "C"
