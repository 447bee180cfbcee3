// Asynchronous NetCDF-3 (classic format) writer for model output.
//
// Native replacement for the reference's NetCDF-Fortran output dependency
// (reference input_output.f90:95-217 writes one file per output step).
// Writing the classic format directly avoids any library dependency, and a
// background worker thread takes file encoding + disk I/O off the Python
// step loop: the host submits a snapshot (deep-copied) and returns
// immediately, so output-every-step runs do not throttle stepping.
//
// File schema matches the reference exactly: dims (time=UNLIMITED, lon,
// lat, lev), float32 vars u,v,t,q,phi (time,lev,lat,lon), ps (time,lat,lon)
// with the same long_name/units attributes.
//
// C ABI (ctypes):
//   int  ncw_write_file(...)  — synchronous write, returns 0 on success
//   int  ncw_submit(...)      — enqueue for the worker thread
//   int  ncw_drain()          — block until queue empty; files written
//   int  ncw_pending()        — jobs still queued/in-flight

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Big-endian buffer encoding
// ---------------------------------------------------------------------
struct Buf {
    std::vector<uint8_t> d;
    void u32(uint32_t v) {
        d.push_back(v >> 24); d.push_back(v >> 16);
        d.push_back(v >> 8); d.push_back(v);
    }
    void f32(float v) {
        uint32_t u;
        std::memcpy(&u, &v, 4);
        u32(u);
    }
    void f32s(const float* p, size_t n) {
        d.reserve(d.size() + 4 * n);
        for (size_t i = 0; i < n; ++i) f32(p[i]);
    }
    void name(const std::string& s) {  // netcdf "name": len + bytes + pad4
        u32((uint32_t)s.size());
        d.insert(d.end(), s.begin(), s.end());
        while (d.size() % 4) d.push_back(0);
    }
    void text_attr(const std::string& aname, const std::string& val) {
        name(aname);
        u32(2);  // NC_CHAR
        u32((uint32_t)val.size());
        d.insert(d.end(), val.begin(), val.end());
        while (d.size() % 4) d.push_back(0);
    }
    size_t size() const { return d.size(); }
};

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;
constexpr uint32_t NC_FLOAT = 5;

struct VarDef {
    std::string vname;
    std::vector<uint32_t> dimids;
    std::vector<std::pair<std::string, std::string>> atts;
    uint32_t vsize;   // bytes (per record for record vars), padded to 4
    bool record;
    uint32_t begin;   // file offset (filled in layout pass)
};

struct Snapshot {
    std::string path;
    int ix, il, kx;
    float time_value;
    std::string time_units;
    std::vector<float> lon, lat, lev, u, v, t, q, phi, ps;
};

int write_snapshot(const Snapshot& s) {
    const uint32_t ix = s.ix, il = s.il, kx = s.kx;
    const uint32_t n3 = kx * il * ix, n2 = il * ix;

    // dims: 0=time(record) 1=lon 2=lat 3=lev
    std::vector<VarDef> vars = {
        {"time", {0}, {{"units", s.time_units}}, 4, true, 0},
        {"lon", {1}, {{"long_name", "longitude"}}, 4 * ix, false, 0},
        {"lat", {2}, {{"long_name", "latitude"}}, 4 * il, false, 0},
        {"lev", {3}, {{"long_name", "atmosphere_sigma_coordinate"}},
         4 * kx, false, 0},
        {"u", {0, 3, 2, 1}, {{"long_name", "eastward_wind"},
                             {"units", "m/s"}}, 4 * n3, true, 0},
        {"v", {0, 3, 2, 1}, {{"long_name", "northward_wind"},
                             {"units", "m/s"}}, 4 * n3, true, 0},
        {"t", {0, 3, 2, 1}, {{"long_name", "air_temperature"},
                             {"units", "K"}}, 4 * n3, true, 0},
        {"q", {0, 3, 2, 1}, {{"long_name", "specific_humidity"},
                             {"units", "1"}}, 4 * n3, true, 0},
        {"phi", {0, 3, 2, 1}, {{"long_name", "geopotential_height"},
                               {"units", "m"}}, 4 * n3, true, 0},
        {"ps", {0, 2, 1}, {{"long_name", "surface_air_pressure"},
                           {"units", "Pa"}}, 4 * n2, true, 0},
    };

    // ---- header ----
    Buf h;
    h.d = {'C', 'D', 'F', 1};
    h.u32(1);  // numrecs = 1
    h.u32(NC_DIMENSION); h.u32(4);
    h.name("time"); h.u32(0);          // record dim
    h.name("lon"); h.u32(ix);
    h.name("lat"); h.u32(il);
    h.name("lev"); h.u32(kx);
    h.u32(0); h.u32(0);                // no global attributes

    // variable list: two passes (sizes depend only on header content)
    auto emit_vars = [&](Buf& b) {
        b.u32(NC_VARIABLE); b.u32((uint32_t)vars.size());
        for (const auto& v : vars) {
            b.name(v.vname);
            b.u32((uint32_t)v.dimids.size());
            for (auto dmid : v.dimids) b.u32(dmid);
            if (v.atts.empty()) { b.u32(0); b.u32(0); }
            else {
                b.u32(NC_ATTRIBUTE); b.u32((uint32_t)v.atts.size());
                for (const auto& a : v.atts) b.text_attr(a.first, a.second);
            }
            b.u32(NC_FLOAT);
            b.u32(v.vsize);
            b.u32(v.begin);
        }
    };
    Buf probe = h;
    emit_vars(probe);
    uint32_t header_size = (uint32_t)probe.size();

    // layout: fixed vars first, then the record block
    uint32_t off = header_size;
    for (auto& v : vars) if (!v.record) { v.begin = off; off += v.vsize; }
    for (auto& v : vars) if (v.record) { v.begin = off; off += v.vsize; }

    Buf out = h;
    emit_vars(out);

    // ---- data ----
    out.f32s(s.lon.data(), ix);
    out.f32s(s.lat.data(), il);
    out.f32s(s.lev.data(), kx);
    out.f32(s.time_value);
    out.f32s(s.u.data(), n3);
    out.f32s(s.v.data(), n3);
    out.f32s(s.t.data(), n3);
    out.f32s(s.q.data(), n3);
    out.f32s(s.phi.data(), n3);
    out.f32s(s.ps.data(), n2);

    FILE* f = std::fopen(s.path.c_str(), "wb");
    if (!f) return 1;
    size_t n = std::fwrite(out.d.data(), 1, out.d.size(), f);
    std::fclose(f);
    return n == out.d.size() ? 0 : 2;
}

// ---------------------------------------------------------------------
// Async worker
// ---------------------------------------------------------------------
// Intentionally leaked: a detached worker may still be blocked on the
// condition variable at process exit, and running its destructor then is
// undefined behavior (observed as a hang in __run_exit_handlers).
std::mutex& g_mu = *new std::mutex;
std::condition_variable& g_cv = *new std::condition_variable;
std::queue<Snapshot>& g_queue = *new std::queue<Snapshot>;
bool g_started = false;
int g_inflight = 0;
int g_errors = 0;

void worker() {
    for (;;) {
        Snapshot job;
        {
            std::unique_lock<std::mutex> lk(g_mu);
            g_cv.wait(lk, [] { return !g_queue.empty(); });
            job = std::move(g_queue.front());
            g_queue.pop();
            ++g_inflight;
        }
        int rc = write_snapshot(job);
        {
            std::lock_guard<std::mutex> lk(g_mu);
            --g_inflight;
            if (rc) ++g_errors;
        }
        g_cv.notify_all();
    }
}

Snapshot make_snapshot(const char* path, int ix, int il, int kx,
                       const float* lon, const float* lat, const float* lev,
                       float time_value, const char* time_units,
                       const float* u, const float* v, const float* t,
                       const float* q, const float* phi, const float* ps) {
    Snapshot s;
    s.path = path;
    s.ix = ix; s.il = il; s.kx = kx;
    s.time_value = time_value;
    s.time_units = time_units;
    size_t n3 = (size_t)kx * il * ix, n2 = (size_t)il * ix;
    s.lon.assign(lon, lon + ix);
    s.lat.assign(lat, lat + il);
    s.lev.assign(lev, lev + kx);
    s.u.assign(u, u + n3);
    s.v.assign(v, v + n3);
    s.t.assign(t, t + n3);
    s.q.assign(q, q + n3);
    s.phi.assign(phi, phi + n3);
    s.ps.assign(ps, ps + n2);
    return s;
}

}  // namespace

extern "C" {

int ncw_write_file(const char* path, int ix, int il, int kx,
                   const float* lon, const float* lat, const float* lev,
                   float time_value, const char* time_units,
                   const float* u, const float* v, const float* t,
                   const float* q, const float* phi, const float* ps) {
    return write_snapshot(make_snapshot(path, ix, il, kx, lon, lat, lev,
                                        time_value, time_units,
                                        u, v, t, q, phi, ps));
}

int ncw_submit(const char* path, int ix, int il, int kx,
               const float* lon, const float* lat, const float* lev,
               float time_value, const char* time_units,
               const float* u, const float* v, const float* t,
               const float* q, const float* phi, const float* ps) {
    Snapshot s = make_snapshot(path, ix, il, kx, lon, lat, lev, time_value,
                               time_units, u, v, t, q, phi, ps);
    {
        std::lock_guard<std::mutex> lk(g_mu);
        if (!g_started) {
            std::thread(worker).detach();
            g_started = true;
        }
        g_queue.push(std::move(s));
    }
    g_cv.notify_all();
    return 0;
}

int ncw_drain() {
    std::unique_lock<std::mutex> lk(g_mu);
    g_cv.wait(lk, [] { return g_queue.empty() && g_inflight == 0; });
    int e = g_errors;
    g_errors = 0;
    return e;
}

int ncw_pending() {
    std::lock_guard<std::mutex> lk(g_mu);
    return (int)g_queue.size() + g_inflight;
}

}  // extern "C"
