// tpumesh: constrained Delaunay triangulation with Ruppert-style quality
// refinement. A from-scratch replacement for the meshing kernel the
// reference framework vendors (Shewchuk's Triangle); same capability
// surface -- PSLG input with point/segment markers, hole seeds, regional
// attributes with per-region area constraints, minimum-angle quality
// bound, optional suppression of boundary Steiner points ("-Y") and
// pruning of unused vertices ("-j") -- but an independent implementation:
// Bowyer-Watson incremental insertion with an exact-arithmetic orient2d
// (expansion arithmetic per Shewchuk's published adaptive-precision
// papers), double-double filtered incircle, pipe-based constraint
// recovery, flood-fill region classification, and off-center (Ungor)
// refinement points.
//
// Exposed as a small C ABI consumed from Python via ctypes
// (xfemm_tpu/mesh/mesher.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ===================================================================== //
// exact / adaptive predicates                                           //
// ===================================================================== //

inline void two_sum(double a, double b, double &x, double &y) {
    x = a + b;
    double bv = x - a;
    y = (a - (x - bv)) + (b - bv);
}
inline void two_product(double a, double b, double &x, double &y) {
    x = a * b;
    y = std::fma(a, b, -x);
}

// Expansion arithmetic: nonoverlapping sequence of doubles whose sum is
// the exact value (Shewchuk, "Adaptive Precision Floating-Point
// Arithmetic and Fast Robust Geometric Predicates").
inline int grow_expansion(int elen, double *e, double b) {
    double q = b;
    int hidx = 0;
    double h[40];
    for (int i = 0; i < elen; ++i) {
        double qn, hh;
        two_sum(q, e[i], qn, hh);
        if (hh != 0.0) h[hidx++] = hh;
        q = qn;
    }
    if (q != 0.0 || hidx == 0) h[hidx++] = q;
    std::memcpy(e, h, hidx * sizeof(double));
    return hidx;
}

// Exact orient2d sign: det = ax*by - ax*cy - cx*by + cx*cy
//                           - ay*bx + ay*cx + cy*bx - cy*cx
double orient2d_exact(const double *pa, const double *pb, const double *pc) {
    double e[40];
    int elen = 0;
    double hi, lo;
    auto addprod = [&](double u, double v) {
        two_product(u, v, hi, lo);
        if (lo != 0.0 || elen == 0) elen = grow_expansion(elen, e, lo);
        elen = grow_expansion(elen, e, hi);
    };
    addprod(pa[0], pb[1]);
    addprod(-pa[0], pc[1]);
    addprod(-pc[0], pb[1]);
    addprod(pc[0], pc[1]);
    addprod(-pa[1], pb[0]);
    addprod(pa[1], pc[0]);
    addprod(pc[1], pb[0]);
    addprod(-pc[1], pc[0]);
    double s = 0.0;
    for (int i = 0; i < elen; ++i) s += e[i];
    // the largest-magnitude component carries the sign; the plain sum of a
    // nonoverlapping expansion is a faithful estimate
    return s;
}

double orient2d(const double *pa, const double *pb, const double *pc) {
    double detleft = (pa[0] - pc[0]) * (pb[1] - pc[1]);
    double detright = (pa[1] - pc[1]) * (pb[0] - pc[0]);
    double det = detleft - detright;
    double detsum;
    if (detleft > 0.0) {
        if (detright <= 0.0) return det;
        detsum = detleft + detright;
    } else if (detleft < 0.0) {
        if (detright >= 0.0) return det;
        detsum = -detleft - detright;
    } else {
        return det;
    }
    double errbound = 3.3306690738754716e-16 * detsum;
    if (det >= errbound || -det >= errbound) return det;
    return orient2d_exact(pa, pb, pc);
}

// double-double arithmetic for the incircle second-stage filter
struct dd {
    double hi, lo;
};
inline dd dd_two(double h, double l) { return {h, l}; }
inline dd dd_add(dd a, dd b) {
    double s, e;
    two_sum(a.hi, b.hi, s, e);
    e += a.lo + b.lo;
    double hi, lo;
    two_sum(s, e, hi, lo);
    return {hi, lo};
}
inline dd dd_neg(dd a) { return {-a.hi, -a.lo}; }
inline dd dd_mul(dd a, dd b) {
    double p, e;
    two_product(a.hi, b.hi, p, e);
    e += a.hi * b.lo + a.lo * b.hi;
    double hi, lo;
    two_sum(p, e, hi, lo);
    return {hi, lo};
}
inline dd dd_diff(double a, double b) {
    double x, y;
    two_sum(a, -b, x, y);
    return {x, y};
}

// incircle: > 0 if pd inside circumcircle of CCW triangle (pa,pb,pc).
// Stage 1 double filter; stage 2 double-double (~106 bits); remaining
// ties are treated as exactly cocircular.
double incircle(const double *pa, const double *pb, const double *pc,
                const double *pd) {
    double adx = pa[0] - pd[0], ady = pa[1] - pd[1];
    double bdx = pb[0] - pd[0], bdy = pb[1] - pd[1];
    double cdx = pc[0] - pd[0], cdy = pc[1] - pd[1];

    double bdxcdy = bdx * cdy, cdxbdy = cdx * bdy;
    double alift = adx * adx + ady * ady;
    double cdxady = cdx * ady, adxcdy = adx * cdy;
    double blift = bdx * bdx + bdy * bdy;
    double adxbdy = adx * bdy, bdxady = bdx * ady;
    double clift = cdx * cdx + cdy * cdy;

    double det = alift * (bdxcdy - cdxbdy) + blift * (cdxady - adxcdy) +
                 clift * (adxbdy - bdxady);
    double permanent = (std::fabs(bdxcdy) + std::fabs(cdxbdy)) * alift +
                       (std::fabs(cdxady) + std::fabs(adxcdy)) * blift +
                       (std::fabs(adxbdy) + std::fabs(bdxady)) * clift;
    double errbound = 1.1102230246251565e-14 * permanent;
    if (det > errbound || -det > errbound) return det;

    dd Adx = dd_diff(pa[0], pd[0]), Ady = dd_diff(pa[1], pd[1]);
    dd Bdx = dd_diff(pb[0], pd[0]), Bdy = dd_diff(pb[1], pd[1]);
    dd Cdx = dd_diff(pc[0], pd[0]), Cdy = dd_diff(pc[1], pd[1]);
    dd Alift = dd_add(dd_mul(Adx, Adx), dd_mul(Ady, Ady));
    dd Blift = dd_add(dd_mul(Bdx, Bdx), dd_mul(Bdy, Bdy));
    dd Clift = dd_add(dd_mul(Cdx, Cdx), dd_mul(Cdy, Cdy));
    dd m1 = dd_add(dd_mul(Bdx, Cdy), dd_neg(dd_mul(Cdx, Bdy)));
    dd m2 = dd_add(dd_mul(Cdx, Ady), dd_neg(dd_mul(Adx, Cdy)));
    dd m3 = dd_add(dd_mul(Adx, Bdy), dd_neg(dd_mul(Bdx, Ady)));
    dd D = dd_add(dd_add(dd_mul(Alift, m1), dd_mul(Blift, m2)),
                  dd_mul(Clift, m3));
    double res = D.hi + D.lo;
    if (std::fabs(res) < 1e-28 * permanent) return 0.0;
    return res;
}

// ===================================================================== //
// mesh data structures                                                  //
// ===================================================================== //

struct Tri {
    int v[3];    // vertices, CCW
    int n[3];    // neighbor across edge opposite v[i] (edge v[i+1],v[i+2])
    int attr;
    bool dead;
    uint32_t stamp = 0;  // slot generation: bumped on every reuse so a
                         // stale queue entry cannot act on the NEW
                         // triangle occupying a recycled slot
};

inline uint64_t ekey(int a, int b) {
    if (a > b) std::swap(a, b);
    return (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
}

struct Mesh {
    std::vector<double> px, py;
    std::vector<int> vmark;
    std::vector<uint8_t> vtype;  // 0 input, 1 segment-split, 2 free
    std::vector<uint8_t> vdead;  // deleted by Chew's free-vertex removal
    std::vector<int> vtri;  // one live triangle containing vertex v
    std::vector<Tri> tris;
    std::vector<int> freelist;
    std::unordered_map<uint64_t, int> segmap;  // constrained edge -> marker
    std::unordered_set<uint64_t> protected_segs;  // "-Y": never split these
    std::vector<double> region_maxarea;        // indexed by attr-1
    double minangle = 0.0;
    bool no_boundary_steiner = false;
    int n_input = 0;   // vertices below this id are input (pre-refine)
    int nsuper0 = 0;
    int last_tri = 0;

    bool is_protected(uint64_t key) const {
        return protected_segs.count(key) != 0;
    }

    void pt(int i, double *out) const {
        out[0] = px[i];
        out[1] = py[i];
    }
    int addv(double x, double y, int mark) {
        px.push_back(x);
        py.push_back(y);
        vmark.push_back(mark);
        vtype.push_back(2);
        vdead.push_back(0);
        vtri.push_back(-1);
        return int(px.size()) - 1;
    }
    int newtri(int a, int b, int c, int attr) {
        int t;
        if (!freelist.empty()) {
            t = freelist.back();
            freelist.pop_back();
        } else {
            tris.push_back(Tri());
            t = int(tris.size()) - 1;
        }
        Tri &T = tris[t];
        T.v[0] = a;
        T.v[1] = b;
        T.v[2] = c;
        T.n[0] = T.n[1] = T.n[2] = -1;
        T.attr = attr;
        T.dead = false;
        ++T.stamp;
        vtri[a] = vtri[b] = vtri[c] = t;
        return t;
    }
    void killtri(int t) {
        tris[t].dead = true;
        freelist.push_back(t);
    }
    bool is_constrained(int a, int b) const {
        return segmap.count(ekey(a, b)) != 0;
    }
    double orient(int a, int b, int c) const {
        double pa[2], pb[2], pc[2];
        pt(a, pa);
        pt(b, pb);
        pt(c, pc);
        return orient2d(pa, pb, pc);
    }
    double orient_pt(int a, int b, const double *p) const {
        double pa[2], pb[2];
        pt(a, pa);
        pt(b, pb);
        return orient2d(pa, pb, p);
    }
    double incircle_tri(int t, const double *p) const {
        double pa[2], pb[2], pc[2];
        pt(tris[t].v[0], pa);
        pt(tris[t].v[1], pb);
        pt(tris[t].v[2], pc);
        return incircle(pa, pb, pc, p);
    }
    int vidx(int t, int v) const {
        for (int i = 0; i < 3; ++i)
            if (tris[t].v[i] == v) return i;
        return -1;
    }
    void relink(int t, int oldn, int newn) {
        if (t < 0) return;
        for (int i = 0; i < 3; ++i)
            if (tris[t].n[i] == oldn) {
                tris[t].n[i] = newn;
                return;
            }
    }

    // find live triangle with directed edge (a,b); returns (tri, local
    // index of the edge's opposite vertex) or (-1,-1). Walks around a.
    bool find_edge(int a, int b, int &t_out, int &i_out) const {
        int t0 = vtri[a];
        if (t0 < 0 || tris[t0].dead) return false;
        // walk around vertex a in both directions
        for (int dir = 0; dir < 2; ++dir) {
            int t = t0;
            int guard = 0;
            while (t >= 0 && guard++ < 1 << 20) {
                int ia = vidx(t, a);
                if (ia < 0) break;
                int nxt = tris[t].v[(ia + 1) % 3];
                int prv = tris[t].v[(ia + 2) % 3];
                if (nxt == b) {
                    t_out = t;
                    i_out = (ia + 2) % 3;  // edge (a,b) is opposite v[ia+2]
                    return true;
                }
                if (prv == b) {
                    // directed edge (b,a) in this triangle; keep walking --
                    // caller wants (a,b) direction
                }
                // move to the next triangle around a
                t = (dir == 0) ? tris[t].n[(ia + 1) % 3]
                               : tris[t].n[(ia + 2) % 3];
                if (t == t0) break;
            }
        }
        return false;
    }
    bool edge_exists(int a, int b) const {
        int t, i;
        return find_edge(a, b, t, i) || find_edge(b, a, t, i);
    }
};

// --------------------------------------------------------------------- //
// point location                                                        //
// --------------------------------------------------------------------- //
int locate(Mesh &m, const double *p, int &onedge, int hint = -1) {
    int t = hint >= 0 ? hint : m.last_tri;
    if (t < 0 || t >= (int)m.tris.size() || m.tris[t].dead) {
        t = -1;
        for (int i = int(m.tris.size()) - 1; i >= 0; --i)
            if (!m.tris[i].dead) {
                t = i;
                break;
            }
        if (t < 0) return -1;
    }
    int steps = 0;
    const int maxsteps = int(m.tris.size()) * 4 + 64;
    int prev = -1;
    while (true) {
        if (++steps > maxsteps) return -1;
        const Tri &T = m.tris[t];
        double o[3];
        int cross = -1;
        double worst = 0.0;
        for (int i = 0; i < 3; ++i) {
            int a = T.v[(i + 1) % 3], b = T.v[(i + 2) % 3];
            o[i] = m.orient_pt(a, b, p);
            if (o[i] < worst && T.n[i] != prev) {
                worst = o[i];
                cross = i;
            }
        }
        if (worst == 0.0) {
            // also allow crossing back if that's the only negative edge
            for (int i = 0; i < 3; ++i)
                if (o[i] < worst) {
                    worst = o[i];
                    cross = i;
                }
        }
        if (cross < 0) {
            onedge = -1;
            for (int i = 0; i < 3; ++i)
                if (o[i] == 0.0) onedge = i;
            m.last_tri = t;
            return t;
        }
        int nt = T.n[cross];
        if (nt < 0) return -1;
        prev = t;
        t = nt;
    }
}

// --------------------------------------------------------------------- //
// Bowyer-Watson insertion                                               //
// --------------------------------------------------------------------- //
// Insert existing vertex v located in triangle t0; appends created
// triangles to out_newtris if non-null. Cavity growth never crosses
// constrained edges, except the designated ``split_key`` edge (used when
// splitting a constrained segment at a point on it -- the caller updates
// segmap afterwards). Points exactly on a hull edge are supported: the
// fan simply leaves the two half-edges open.
bool insert_vertex(Mesh &m, int v, int t0, int onedge,
                   std::vector<int> *out_newtris = nullptr,
                   uint64_t split_key = ~uint64_t(0)) {
    double p[2];
    m.pt(v, p);

    std::vector<int> cavity;
    std::unordered_set<int> incav;
    std::vector<int> stack;
    stack.push_back(t0);
    incav.insert(t0);
    if (onedge >= 0) {
        int nt = m.tris[t0].n[onedge];
        int a = m.tris[t0].v[(onedge + 1) % 3];
        int b = m.tris[t0].v[(onedge + 2) % 3];
        bool crossable = !m.is_constrained(a, b) || ekey(a, b) == split_key;
        if (nt >= 0 && crossable) {
            stack.push_back(nt);
            incav.insert(nt);
        }
    }
    while (!stack.empty()) {
        int t = stack.back();
        stack.pop_back();
        cavity.push_back(t);
        for (int i = 0; i < 3; ++i) {
            int nt = m.tris[t].n[i];
            if (nt < 0 || incav.count(nt)) continue;
            int a = m.tris[t].v[(i + 1) % 3];
            int b = m.tris[t].v[(i + 2) % 3];
            if (m.is_constrained(a, b) && ekey(a, b) != split_key) continue;
            if (m.incircle_tri(nt, p) > 0.0) {
                incav.insert(nt);
                stack.push_back(nt);
            }
        }
    }

    struct BEdge {
        int a, b, out, attr;
        bool degenerate;  // p lies exactly on this (hull/constraint) edge
    };
    std::vector<BEdge> bedges;
    auto build_bedges = [&]() {
        bedges.clear();
        for (int t : cavity) {
            for (int i = 0; i < 3; ++i) {
                int nt = m.tris[t].n[i];
                if (nt >= 0 && incav.count(nt)) continue;
                bedges.push_back({m.tris[t].v[(i + 1) % 3],
                                  m.tris[t].v[(i + 2) % 3], nt,
                                  m.tris[t].attr, false});
            }
        }
    };
    build_bedges();

    // validity guard: every cavity boundary edge must see p strictly left.
    // An edge containing p exactly (orient == 0) is marked degenerate and
    // produces no fan triangle (the point splits that edge); a strictly
    // negative edge shrinks the cavity (filtered-incircle slip guard).
    bool again = true;
    while (again) {
        again = false;
        for (auto &be : bedges) {
            double o = m.orient_pt(be.a, be.b, p);
            // the designated split edge is ON-edge by contract, even if
            // the rounded split point is a hair off the exact line
            if (o == 0.0 || (split_key != ~uint64_t(0) &&
                             ekey(be.a, be.b) == split_key)) {
                be.degenerate = true;
                continue;
            }
            if (o < 0.0) {
                int owner = -1;
                for (int t : cavity) {
                    for (int i = 0; i < 3; ++i)
                        if (m.tris[t].v[(i + 1) % 3] == be.a &&
                            m.tris[t].v[(i + 2) % 3] == be.b) {
                            owner = t;
                            break;
                        }
                    if (owner >= 0) break;
                }
                if (owner < 0 || cavity.size() <= 1) return false;
                incav.erase(owner);
                cavity.erase(std::find(cavity.begin(), cavity.end(), owner));
                build_bedges();
                again = true;
                break;
            }
        }
    }
    // a degenerate edge with a live neighbor outside the cavity cannot be
    // split one-sidedly (would leave a T-junction): reject unless it is a
    // hull edge
    for (auto &be : bedges)
        if (be.degenerate && be.out >= 0) return false;

    for (int t : cavity) m.killtri(t);

    std::vector<int> newtris;
    newtris.reserve(bedges.size());
    std::unordered_map<int, int> tri_by_a, tri_by_b;
    for (auto &be : bedges) {
        if (be.degenerate) continue;
        int t = m.newtri(v, be.a, be.b, be.attr);
        m.tris[t].n[0] = be.out;
        if (be.out >= 0) {
            for (int k = 0; k < 3; ++k) {
                if (m.tris[be.out].v[(k + 1) % 3] == be.b &&
                    m.tris[be.out].v[(k + 2) % 3] == be.a) {
                    m.tris[be.out].n[k] = t;
                    break;
                }
            }
        }
        tri_by_a[be.a] = t;
        tri_by_b[be.b] = t;
        newtris.push_back(t);
    }
    for (int t : newtris) {
        int a = m.tris[t].v[1], b = m.tris[t].v[2];
        auto it = tri_by_a.find(b);
        m.tris[t].n[1] = (it != tri_by_a.end()) ? it->second : -1;
        auto it2 = tri_by_b.find(a);
        m.tris[t].n[2] = (it2 != tri_by_b.end()) ? it2->second : -1;
    }
    if (!newtris.empty()) m.last_tri = newtris[0];
    if (out_newtris)
        out_newtris->insert(out_newtris->end(), newtris.begin(),
                            newtris.end());
    return true;
}

// append + insert; returns vertex id, or -1 on failure/duplicate.
// ``split_key``: constrained-edge key the point is being inserted onto
// (enables crossing/splitting that one edge).
int add_point(Mesh &m, double x, double y, int mark,
              std::vector<int> *out_newtris = nullptr, int hint = -1,
              uint64_t split_key = ~uint64_t(0)) {
    double p[2] = {x, y};
    int onedge = -1;
    int t = locate(m, p, onedge, hint);
    // Segment splits force the on-edge topology: the midpoint of (a,b)
    // may round a hair off the exact line, and treating it as interior
    // would leave the old edge alive plus a zero-area sliver (a,b,v).
    if (split_key != ~uint64_t(0)) {
        int sa = int(split_key >> 32), sb = int(split_key & 0xffffffffu);
        int te, ie;
        if (m.find_edge(sa, sb, te, ie) || m.find_edge(sb, sa, te, ie)) {
            t = te;
            onedge = ie;
        } else if (getenv("TPUMESH_DEBUG")) {
            fprintf(stderr, "[tpumesh] split %d-%d: edge not found\n", sa,
                    sb);
        }
    }
    if (t < 0) return -1;
    for (int i = 0; i < 3; ++i) {
        int w = m.tris[t].v[i];
        if (m.px[w] == x && m.py[w] == y) return -1;
    }
    // refuse inserting a refinement point exactly onto a constrained edge
    // we are not allowed to split (the caller falls back to splitting it)
    if (onedge >= 0) {
        int a = m.tris[t].v[(onedge + 1) % 3];
        int b = m.tris[t].v[(onedge + 2) % 3];
        if (m.is_constrained(a, b) && ekey(a, b) != split_key) return -1;
    }
    int v = m.addv(x, y, mark);
    if (!insert_vertex(m, v, t, onedge, out_newtris, split_key)) {
        m.px.pop_back();
        m.py.pop_back();
        m.vmark.pop_back();
        m.vtype.pop_back();
        m.vdead.pop_back();
        m.vtri.pop_back();
        return -1;
    }
    return v;
}

// --------------------------------------------------------------------- //
// constraint recovery                                                    //
// --------------------------------------------------------------------- //

// flip the edge opposite local vertex i of triangle t; returns the
// (t,u) pair forming the new diagonal, or false if the quad is not
// strictly convex.
bool flip_edge(Mesh &m, int t, int i) {
    int u = m.tris[t].n[i];
    if (u < 0) return false;
    int a = m.tris[t].v[(i + 1) % 3];
    int b = m.tris[t].v[(i + 2) % 3];
    int c = m.tris[t].v[i];
    int j = -1;
    for (int k = 0; k < 3; ++k)
        if (m.tris[u].v[(k + 1) % 3] == b && m.tris[u].v[(k + 2) % 3] == a)
            j = k;
    if (j < 0) return false;
    int d = m.tris[u].v[j];
    if (m.orient(c, a, d) <= 0.0) return false;
    if (m.orient(d, b, c) <= 0.0) return false;

    int t_bc = m.tris[t].n[(i + 1) % 3];
    int t_ca = m.tris[t].n[(i + 2) % 3];
    int u_ad = m.tris[u].n[(j + 1) % 3];
    int u_db = m.tris[u].n[(j + 2) % 3];

    m.tris[t].v[0] = c;
    m.tris[t].v[1] = a;
    m.tris[t].v[2] = d;
    m.tris[u].v[0] = d;
    m.tris[u].v[1] = b;
    m.tris[u].v[2] = c;
    m.tris[t].n[0] = u_ad;
    m.tris[t].n[1] = u;
    m.tris[t].n[2] = t_ca;
    m.tris[u].n[0] = t_bc;
    m.tris[u].n[1] = t;
    m.tris[u].n[2] = u_db;
    m.relink(u_ad, u, t);
    m.relink(t_bc, t, u);
    m.vtri[a] = t;
    m.vtri[b] = u;
    m.vtri[c] = t;
    m.vtri[d] = t;
    return true;
}

bool recover_segment(Mesh &m, int a, int b, int marker, int depth = 0) {
    if (a == b || depth > 64) return false;
    if (m.edge_exists(a, b)) {
        m.segmap[ekey(a, b)] = marker;
        return true;
    }
    // a vertex exactly on the open segment splits the constraint
    {
        double ax = m.px[a], ay = m.py[a], bx = m.px[b], by = m.py[b];
        double lox = std::fmin(ax, bx), hix = std::fmax(ax, bx);
        double loy = std::fmin(ay, by), hiy = std::fmax(ay, by);
        for (int v = 0; v < (int)m.px.size(); ++v) {
            if (v == a || v == b || m.vtri[v] < 0) continue;
            if (m.px[v] < lox || m.px[v] > hix || m.py[v] < loy ||
                m.py[v] > hiy)
                continue;
            if (m.orient(a, b, v) == 0.0) {
                double t = (hix - lox > hiy - loy)
                               ? (m.px[v] - ax) / (bx - ax)
                               : (m.py[v] - ay) / (by - ay);
                if (t > 0.0 && t < 1.0)
                    return recover_segment(m, a, v, marker, depth + 1) &&
                           recover_segment(m, v, b, marker, depth + 1);
            }
        }
    }
    // Queue-based crossing-edge flipping (Anglada's CDT edge insertion):
    // collect the edges crossed by a->b, then repeatedly flip; edges whose
    // quad is nonconvex or whose flip still crosses go to the back.
    auto crosses_ab = [&](int c, int d) {
        double o1 = m.orient(a, b, c);
        double o2 = m.orient(a, b, d);
        if (o1 == 0.0 || o2 == 0.0 || (o1 > 0) == (o2 > 0)) return false;
        double o3 = m.orient(c, d, a);
        double o4 = m.orient(c, d, b);
        return o3 != 0.0 && o4 != 0.0 && (o3 > 0) != (o4 > 0);
    };

    // initial crossing edge from a's wedge
    std::deque<uint64_t> cross;
    {
        int t0 = m.vtri[a];
        if (t0 < 0) return false;
        std::unordered_set<int> seen;
        std::vector<int> st{t0};
        int c0 = -1, d0 = -1;
        while (!st.empty()) {
            int t = st.back();
            st.pop_back();
            if (t < 0 || m.tris[t].dead || seen.count(t)) continue;
            int ia = m.vidx(t, a);
            if (ia < 0) continue;
            seen.insert(t);
            int c = m.tris[t].v[(ia + 1) % 3];
            int d = m.tris[t].v[(ia + 2) % 3];
            if (crosses_ab(c, d)) {
                c0 = c;
                d0 = d;
                break;
            }
            st.push_back(m.tris[t].n[(ia + 1) % 3]);
            st.push_back(m.tris[t].n[(ia + 2) % 3]);
        }
        if (c0 < 0) return false;
        // walk the pipe collecting all crossing edges. The wedge triangle
        // holds the directed edge (c0,d0), so the far side holds (d0,c0).
        cross.push_back(ekey(c0, d0));
        int te, ie;
        if (!m.find_edge(d0, c0, te, ie)) return false;
        int guard2 = 0;
        int t = te;
        while (guard2++ < (int)m.tris.size() + 16) {
            if (m.vidx(t, b) >= 0) break;  // reached b
            bool advanced = false;
            for (int i = 0; i < 3 && !advanced; ++i) {
                int cc = m.tris[t].v[(i + 1) % 3];
                int dd2 = m.tris[t].v[(i + 2) % 3];
                uint64_t k = ekey(cc, dd2);
                if (!cross.empty() && k == cross.back()) continue;
                if (crosses_ab(cc, dd2)) {
                    cross.push_back(k);
                    t = m.tris[t].n[i];
                    if (t < 0) return false;
                    advanced = true;
                }
            }
            if (!advanced) break;
        }
    }

    int guard = 0;
    const int maxflips = int(m.tris.size()) * 64 + 65536;
    while (!cross.empty()) {
        if (++guard > maxflips) return false;
        uint64_t key = cross.front();
        cross.pop_front();
        int c = int(key >> 32), d = int(key & 0xffffffffu);
        int t, i;
        if (!m.find_edge(c, d, t, i) && !m.find_edge(d, c, t, i))
            continue;  // edge no longer present
        c = m.tris[t].v[(i + 1) % 3];
        d = m.tris[t].v[(i + 2) % 3];
        if (!crosses_ab(c, d)) continue;
        if (m.is_constrained(c, d)) return false;  // PSLG self-intersection
        int apex_t = m.tris[t].v[i];
        int u = m.tris[t].n[i];
        if (u < 0) return false;
        int j = -1;
        for (int k2 = 0; k2 < 3; ++k2)
            if (m.tris[u].v[(k2 + 1) % 3] == d &&
                m.tris[u].v[(k2 + 2) % 3] == c)
                j = k2;
        int apex_u = j >= 0 ? m.tris[u].v[j] : -1;
        if (!flip_edge(m, t, i)) {
            cross.push_back(ekey(c, d));  // retry later
            continue;
        }
        // new diagonal is (apex_t, apex_u); still crossing? requeue it
        if (apex_u >= 0 && apex_t != a && apex_t != b && apex_u != a &&
            apex_u != b && crosses_ab(apex_t, apex_u))
            cross.push_back(ekey(apex_t, apex_u));
    }
    if (!m.edge_exists(a, b)) return false;
    m.segmap[ekey(a, b)] = marker;
    return true;
}

// --------------------------------------------------------------------- //
// region classification                                                 //
// --------------------------------------------------------------------- //
void flood(Mesh &m, int seed, int attr) {
    std::vector<int> stack{seed};
    while (!stack.empty()) {
        int t = stack.back();
        stack.pop_back();
        if (t < 0 || m.tris[t].dead || m.tris[t].attr != INT32_MIN) continue;
        m.tris[t].attr = attr;
        for (int i = 0; i < 3; ++i) {
            int nt = m.tris[t].n[i];
            if (nt < 0 || m.tris[nt].dead || m.tris[nt].attr != INT32_MIN)
                continue;
            int a = m.tris[t].v[(i + 1) % 3];
            int b = m.tris[t].v[(i + 2) % 3];
            if (m.is_constrained(a, b)) continue;
            stack.push_back(nt);
        }
    }
}

// --------------------------------------------------------------------- //
// refinement                                                            //
// --------------------------------------------------------------------- //
struct CircumData {
    double cx, cy, r2, area, shortest2;
    double cos2opp;   // squared cosine of the angle opposite the shortest edge
    int se_a, se_b;
};

bool circum(const Mesh &m, int t, CircumData &cd) {
    int A = m.tris[t].v[0], B = m.tris[t].v[1], C = m.tris[t].v[2];
    double ax = m.px[A], ay = m.py[A];
    double bx = m.px[B], by = m.py[B];
    double cx = m.px[C], cy = m.py[C];
    double d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by));
    if (d == 0.0) return false;
    double a2 = ax * ax + ay * ay, b2 = bx * bx + by * by,
           c2 = cx * cx + cy * cy;
    cd.cx = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d;
    cd.cy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d;
    double dx = cd.cx - ax, dy = cd.cy - ay;
    cd.r2 = dx * dx + dy * dy;
    cd.area = std::fabs(d) / 4.0;
    double e0 = (bx - cx) * (bx - cx) + (by - cy) * (by - cy);
    double e1 = (cx - ax) * (cx - ax) + (cy - ay) * (cy - ay);
    double e2 = (ax - bx) * (ax - bx) + (ay - by) * (ay - by);
    cd.shortest2 = e0;
    cd.se_a = B;
    cd.se_b = C;
    // Quality metric: squared cosine of the angle opposite the shortest
    // edge, compared against cos^2(minangle) -- the exact arithmetic
    // Triangle uses (testtriangle, triangle.c:7288-7315).  Equivalent to
    // the circumradius test r > ell/(2 sin q) in exact arithmetic, but
    // the roundoff behavior at the bound differs, and matching it keeps
    // borderline just-fixed triangles from being re-flagged.
    double dot = (bx - ax) * (cx - ax) + (by - ay) * (cy - ay);
    double den = e1 * e2;
    if (e1 < cd.shortest2) {
        cd.shortest2 = e1;
        cd.se_a = C;
        cd.se_b = A;
        dot = (cx - bx) * (ax - bx) + (cy - by) * (ay - by);
        den = e2 * e0;
    }
    if (e2 < cd.shortest2) {
        cd.shortest2 = e2;
        cd.se_a = A;
        cd.se_b = B;
        dot = (ax - cx) * (bx - cx) + (ay - cy) * (by - cy);
        den = e0 * e1;
    }
    cd.cos2opp = (den > 0.0) ? dot * dot / den : 1.0;
    return true;
}

inline bool in_diametral(const Mesh &m, int a, int b, double x, double y,
                         bool lens = true) {
    // Diametral LENS (Shewchuk): the point encroaches only if the angle
    // it subtends at the segment exceeds the lens angle derived from the
    // quality bound, not the 90 degrees of the diametral circle. The
    // circle test cascades boundary splits near curved inputs and grades
    // whole regions ~4x finer than the area constraints ask for. Callers
    // that MUST make progress (a proposed point that cannot be inserted)
    // pass lens=false for the plain circle.
    double dax = m.px[a] - x, day = m.py[a] - y;
    double dbx = m.px[b] - x, dby = m.py[b] - y;
    double dot = dax * dbx + day * dby;
    if (dot >= 0.0) return false;
    if (!lens) return true;
    double g = std::cos(m.minangle * M_PI / 180.0);
    g = 2.0 * g * g - 1.0;           // = cos(2*minangle)
    if (g <= 0.0) return true;       // minangle >= 45: plain circle
    double la2 = dax * dax + day * day;
    double lb2 = dbx * dbx + dby * dby;
    return dot * dot >= g * g * la2 * lb2;
}

// Constrained neighbors of v (star walk both directions); returns count
// (capped at 4).
static int constrained_neighbors(const Mesh &m, int v, int out[4]) {
    int cnt = 0;
    int t0 = m.vtri[v];
    if (t0 < 0 || t0 >= (int)m.tris.size() || m.tris[t0].dead) return 0;
    auto visit = [&](int u) {
        for (int i = 0; i < cnt; ++i)
            if (out[i] == u) return;
        if (cnt < 4 && m.is_constrained(v, u)) out[cnt++] = u;
    };
    for (int dir = 0; dir < 2; ++dir) {
        int t = t0, guard = 0;
        while (t >= 0 && guard++ < (1 << 18)) {
            int iv = m.vidx(t, v);
            if (iv < 0) break;
            visit(m.tris[t].v[(iv + 1) % 3]);
            visit(m.tris[t].v[(iv + 2) % 3]);
            t = (dir == 0) ? m.tris[t].n[(iv + 1) % 3]
                           : m.tris[t].n[(iv + 2) % 3];
            if (t == t0) break;
        }
    }
    return cnt;
}

// Walk the constrained chain from v toward u through segment-split
// vertices; returns the terminal (input) vertex or -1.
static int chain_end(const Mesh &m, int v, int u) {
    int prev = v, cur = u, guard = 0;
    while (cur >= 0 && m.vtype[cur] == 1 && guard++ < (1 << 18)) {
        int nb[4];
        int c = constrained_neighbors(m, cur, nb);
        if (c != 2) return -1;
        int nxt = (nb[0] == prev) ? nb[1] : nb[0];
        prev = cur;
        cur = nxt;
    }
    return (cur >= 0 && m.vtype[cur] != 1) ? cur : -1;
}

// Miller-Pav-Walkington rule (as adjusted by Shewchuk, triangle.c
// testtriangle): a skinny triangle whose shortest edge runs between the
// interiors of two DIFFERENT input segments meeting at a common
// endpoint, with both edge endpoints equidistant from that endpoint
// (concentric shell), must NOT be split -- refining it cascades
// forever across the small input angle.
static bool mpw_skip(const Mesh &m, int a, int b) {
    if (m.vtype[a] != 1 || m.vtype[b] != 1) return false;
    if (m.is_constrained(a, b)) return false;   // same subsegment: split
    int na[4], nb_[4];
    if (constrained_neighbors(m, a, na) != 2) return false;
    if (constrained_neighbors(m, b, nb_) != 2) return false;
    int ea0 = chain_end(m, a, na[0]), ea1 = chain_end(m, a, na[1]);
    int eb0 = chain_end(m, b, nb_[0]), eb1 = chain_end(m, b, nb_[1]);
    if (ea0 < 0 || ea1 < 0 || eb0 < 0 || eb1 < 0) return false;
    // same containing segment? then split as usual
    if ((ea0 == eb0 && ea1 == eb1) || (ea0 == eb1 && ea1 == eb0))
        return false;
    int j = -1;
    if (ea0 == eb0 || ea0 == eb1) j = ea0;
    else if (ea1 == eb0 || ea1 == eb1) j = ea1;
    if (j < 0) return false;
    double dax = m.px[a] - m.px[j], day = m.py[a] - m.py[j];
    double dbx = m.px[b] - m.px[j], dby = m.py[b] - m.py[j];
    double d1 = dax * dax + day * day;
    double d2 = dbx * dbx + dby * dby;
    return d1 < 1.001 * d2 && d1 > 0.999 * d2;
}

// Collect the full CCW star of vertex v: star[i] is the triangle
// (v, ring[i], ring[i+1]).  Fails (false) when v lies on the hull (open
// fan) or the walk is inconsistent.
static bool star_of(const Mesh &m, int v, std::vector<int> &ring,
                    std::vector<int> &star) {
    ring.clear();
    star.clear();
    int t0 = m.vtri[v];
    if (t0 < 0 || t0 >= (int)m.tris.size() || m.tris[t0].dead) return false;
    int t = t0, guard = 0;
    do {
        if (guard++ > (1 << 16)) return false;
        int iv = m.vidx(t, v);
        if (iv < 0) return false;
        star.push_back(t);
        ring.push_back(m.tris[t].v[(iv + 1) % 3]);
        t = m.tris[t].n[(iv + 1) % 3];   // CCW-next triangle around v
        if (t < 0) return false;         // hull fan: keep the vertex
    } while (t != t0);
    return ring.size() >= 3;
}

// Delaunay triangulation of the ring polygon [lo..hi] against chord
// (ring[lo], ring[hi]) -- Triangle's triangulatepolygon selection rule:
// the chord's Delaunay partner wins incircle against every other
// candidate. Appends (a,b,c) CCW triples; returns false on failure.
static bool fill_poly_rec(const Mesh &m, const std::vector<int> &ring,
                          int lo, int hi,
                          std::vector<std::array<int, 3>> &out) {
    if (hi - lo < 2) return true;
    int best = -1;
    for (int c = lo + 1; c < hi; ++c) {
        if (m.orient(ring[lo], ring[c], ring[hi]) <= 0.0) continue;
        if (best < 0) {
            best = c;
            continue;
        }
        double pc[2] = {m.px[ring[c]], m.py[ring[c]]};
        double pa[2], pb[2], pd[2];
        pa[0] = m.px[ring[lo]]; pa[1] = m.py[ring[lo]];
        pb[0] = m.px[ring[best]]; pb[1] = m.py[ring[best]];
        pd[0] = m.px[ring[hi]]; pd[1] = m.py[ring[hi]];
        if (incircle(pa, pb, pd, pc) > 0.0) best = c;
    }
    if (best < 0) return false;
    out.push_back({ring[lo], ring[best], ring[hi]});
    return fill_poly_rec(m, ring, lo, best, out) &&
           fill_poly_rec(m, ring, best, hi, out);
}

// Chew's free-vertex deletion (triangle.c splitencsegs:13341-13380
// semantics): remove an interior FREE vertex and re-triangulate its star
// polygon Delaunay. Appends the created triangles to out_newtris.
// Returns false (mesh untouched) if v is not deletable.
static bool delete_free_vertex(Mesh &m, int v,
                               std::vector<int> *out_newtris) {
    if (m.vtype[v] != 2 || m.vdead[v]) return false;
    std::vector<int> ring, star;
    if (!star_of(m, v, ring, star)) return false;
    const int k = (int)ring.size();
    const int attr = m.tris[star[0]].attr;

    std::vector<std::array<int, 3>> tris;
    tris.reserve(k - 2);
    if (!fill_poly_rec(m, ring, 0, k - 1, tris) ||
        (int)tris.size() != k - 2)
        return false;

    // outer neighbor + old star tri per ring edge (ring[i], ring[i+1])
    std::vector<int> out_nb(k), old_tri(k);
    for (int i = 0; i < k; ++i) {
        int t = star[i];
        int iv = m.vidx(t, v);
        out_nb[i] = m.tris[t].n[iv];
        old_tri[i] = t;
    }
    for (int t : star) m.killtri(t);
    m.vtri[v] = -1;
    m.vdead[v] = 1;

    // create new triangles and stitch neighbors
    std::unordered_map<uint64_t, std::pair<int, int>> half;  // ekey->tri,edge
    std::vector<int> created;
    created.reserve(tris.size());
    for (auto &tr : tris)
        created.push_back(m.newtri(tr[0], tr[1], tr[2], attr));
    for (int t : created) {
        for (int i = 0; i < 3; ++i) {
            int a = m.tris[t].v[(i + 1) % 3], b = m.tris[t].v[(i + 2) % 3];
            uint64_t key = ekey(a, b);
            auto it = half.find(key);
            if (it == half.end()) {
                half[key] = {t, i};
            } else {
                m.tris[t].n[i] = it->second.first;
                m.tris[it->second.first].n[it->second.second] = t;
            }
        }
    }
    for (int i = 0; i < k; ++i) {
        int a = ring[i], b = ring[(i + 1) % k];
        auto it = half.find(ekey(a, b));
        if (it == half.end()) continue;    // degenerate; leave hull open
        int t = it->second.first, e = it->second.second;
        if (m.tris[t].n[e] >= 0 && m.tris[t].n[e] != out_nb[i])
            continue;                      // already linked internally
        m.tris[t].n[e] = out_nb[i];
        if (out_nb[i] >= 0) m.relink(out_nb[i], old_tri[i], t);
    }
    if (out_newtris)
        out_newtris->insert(out_newtris->end(), created.begin(),
                            created.end());
    return true;
}

void refine(Mesh &m) {
    const bool dbg_counts = getenv("TPUMESH_COUNTS") != nullptr;
    size_t n_angle_ins = 0, n_area_ins = 0, n_seg_split = 0,
           n_centroid = 0, n_chew_del = 0;
    (void)n_centroid;
    double q = m.minangle * M_PI / 180.0;
    double goodangle = 1.0;          // cos^2(minangle); 1.0 = no quality bound
    if (m.minangle > 0) {
        double c = std::cos(q);
        goodangle = c * c;
    }

    // shortest-edge-first processing (the ordering Triangle uses --
    // enqueuebadtriang: "The shortest edges have the highest priority").
    // Fixing the finest-scale bad triangles first makes insertion radii
    // grow monotonically, which is what bounds the output size (Ruppert's
    // size-optimality argument); stack order costs ~2-3x more Steiner
    // points on graded inputs (motor geometries with corner stubs).
    // Entries are (-shortest_edge^2, triangle); stale entries are skipped
    // on pop by re-checking liveness and badness.
    // Queue entries carry the slot's generation stamp; pop discards an
    // entry whose slot was recycled since the push (Triangle gets the
    // same protection by storing and re-checking the vertex triple,
    // splittriangle triangle.c:13543-13545). Without it, a low-priority
    // entry can act on the brand-new triangle occupying a recycled slot,
    // processing it far out of shortest-edge order -- the resulting deep
    // out-of-order insertions destroy the self-organizing ring structure
    // on co-circular inputs and over-refine interiors everywhere.
    struct BadQueue {
        struct E {
            double negkey;
            int t;
            uint32_t stamp;
            bool operator<(const E &o) const { return negkey < o.negkey; }
        };
        std::priority_queue<E> pq;
        void push(double key, int t, uint32_t stamp) {
            pq.push({-key, t, stamp});
        }
        bool empty() const { return pq.empty(); }
        size_t size() const { return pq.size(); }
        std::pair<int, uint32_t> pop() {
            E e = pq.top();
            pq.pop();
            return {e.t, e.stamp};
        }
    };
    BadQueue pqueue;
    auto queue_push = [&](int t) {
        if (t < 0 || t >= (int)m.tris.size() || m.tris[t].dead ||
            m.tris[t].attr < 0)
            return;
        CircumData cd;
        if (!circum(m, t, cd)) return;
        double maxarea = (m.tris[t].attr >= 1 &&
                          m.tris[t].attr <= (int)m.region_maxarea.size())
                             ? m.region_maxarea[m.tris[t].attr - 1]
                             : 0.0;
        bool bad = (maxarea > 0.0 && cd.area > maxarea) ||
                   (cd.cos2opp > goodangle);
        if (bad) pqueue.push(cd.shortest2, t, m.tris[t].stamp);
    };
    struct QueueShim {
        std::function<void(int)> push_fn;
        void push_back(int t) { push_fn(t); }
    };
    QueueShim queue{queue_push};
    for (int t = 0; t < (int)m.tris.size(); ++t)
        if (!m.tris[t].dead && m.tris[t].attr >= 0) queue_push(t);
    std::deque<uint64_t> segqueue;
    for (auto &kv : m.segmap)
        if (!m.is_protected(kv.first)) segqueue.push_back(kv.first);

    auto seg_adjacent_ok = [&](int a, int b, int &apex1, int &apex2) {
        apex1 = apex2 = -1;
        int t, i;
        if (m.find_edge(a, b, t, i)) apex1 = m.tris[t].v[i];
        if (m.find_edge(b, a, t, i)) apex2 = m.tris[t].v[i];
        return apex1 >= 0 || apex2 >= 0;
    };

    // segments whose split-point insertion failed (degenerate rounding):
    // never retry -- the Chew deletion before a retry would otherwise
    // re-delete the surrounding free vertices forever
    static thread_local std::unordered_set<uint64_t> failed_splits;
    failed_splits.clear();

    // Quality proposals abandoned because the Steiner point encroached a
    // segment that cannot be split (protected, or the split itself
    // failed). Keyed by the triangle's sorted vertex triple: after the
    // undo restores the cavity the SAME triangle reappears under a new
    // index, and without this memory the insert/undo cycle repeats
    // forever. Triangle gets the same give-up behavior for free because
    // its undovertex restores the original triangle records and the
    // consumed bad-triangle record is simply not requeued
    // (splittriangle, triangle.c:13597-13604).
    static thread_local std::unordered_set<uint64_t> givenup;
    givenup.clear();
    auto triple_key = [&](int t) -> uint64_t {
        uint64_t a = m.tris[t].v[0], b = m.tris[t].v[1], c = m.tris[t].v[2];
        if (a > b) std::swap(a, b);
        if (b > c) std::swap(b, c);
        if (a > b) std::swap(a, b);
        uint64_t k = 1469598103934665603ull;          // FNV-1a over the triple
        for (uint64_t v : {a, b, c}) {
            k ^= v;
            k *= 1099511628211ull;
        }
        return k;
    };

    auto split_segment = [&](int a, int b) -> int {
        auto it = m.segmap.find(ekey(a, b));
        if (it == m.segmap.end() || m.is_protected(ekey(a, b)) ||
            failed_splits.count(ekey(a, b))) {
            if (getenv("TPUMESH_DEBUG"))
                fprintf(stderr,
                        "  split REFUSED (%d,%d): inmap=%d prot=%d failed=%d\n",
                        a, b, (int)(it != m.segmap.end()),
                        (int)m.is_protected(ekey(a, b)),
                        (int)failed_splits.count(ekey(a, b)));
            return -1;
        }
        int marker = it->second;
        double dx = m.px[a] - m.px[b], dy = m.py[a] - m.py[b];
        if (dx * dx + dy * dy == 0.0) return -1;

        // Shared-endpoint (small input angle) detection, computed from
        // the flanking apexes BEFORE any deletion -- exactly Triangle's
        // splitencsegs order (triangle.c:13327-13378): the acute flags
        // both gate the Chew deletion per side and pick the split
        // position below.
        bool acuteorg = false, acutedest = false;
        bool acuteorg2 = false, acutedest2 = false;
        {
            int t, i;
            if (m.find_edge(a, b, t, i)) {
                int ap = m.tris[t].v[i];
                acuteorg = m.is_constrained(a, ap);
                acutedest = m.is_constrained(b, ap);
            }
            if (m.find_edge(b, a, t, i)) {
                int ap = m.tris[t].v[i];
                acuteorg2 = m.is_constrained(a, ap);
                acutedest2 = m.is_constrained(b, ap);
            }
        }

        // Chew's algorithm (triangle.c splitencsegs with !conformdel):
        // before splitting, delete FREE vertices inside the segment's
        // diametral circle -- but only on a side whose flanking edges
        // are not themselves subsegments (the acute flags above;
        // triangle.c:13339,13367). Without the deletion, the crowd of
        // rejected-circumcenter vertices near the segment survives the
        // split and cascades further quality refinement (~30% extra
        // points on arc-heavy motor geometries).
        for (int side = 0; side < 2; ++side) {
            if (side == 0 ? (acuteorg || acutedest)
                          : (acuteorg2 || acutedest2))
                continue;
            int guard = 0;
            while (guard++ < 256) {
                int t, i;
                bool f = (side == 0) ? m.find_edge(a, b, t, i)
                                     : m.find_edge(b, a, t, i);
                if (!f) break;
                int apex = m.tris[t].v[i];
                if (m.vtype[apex] != 2) break;
                double dax = m.px[a] - m.px[apex],
                       day = m.py[a] - m.py[apex];
                double dbx = m.px[b] - m.px[apex],
                       dby = m.py[b] - m.py[apex];
                if (dax * dbx + day * dby >= 0.0) break;  // outside circle
                std::vector<int> newt;
                if (!delete_free_vertex(m, apex, &newt)) break;
                ++n_chew_del;
                for (int tt : newt)
                    if (m.tris[tt].attr >= 0) queue.push_back(tt);
            }
        }

        // Concentric-shell split position (triangle.c:13383-13413): when
        // an endpoint is shared with another segment (small input
        // angle), split at the power-of-two distance from that endpoint
        // so successive splittings of adjacent segments land on common
        // shells and stop encroaching each other.
        double split = 0.5;
        acuteorg = acuteorg || acuteorg2;
        acutedest = acutedest || acutedest2;
        if (acuteorg || acutedest) {
            double seglen = std::sqrt(dx * dx + dy * dy);
            double npo2 = 1.0;
            while (seglen > 3.0 * npo2) npo2 *= 2.0;
            while (seglen < 1.5 * npo2) npo2 *= 0.5;
            split = npo2 / seglen;
            if (acutedest) split = 1.0 - split;
        }
        double mx = m.px[a] + split * (m.px[b] - m.px[a]);
        double my = m.py[a] + split * (m.py[b] - m.py[a]);
        {
            // One step of iterative refinement to improve collinearity
            // (triangle.c:13416-13426): without it the rounded split
            // point can land a hair on the UNMESHED side of a hole
            // boundary, where the insertion cavity is empty and the
            // split fails.
            double pa[2], pb[2];
            m.pt(a, pa);
            m.pt(b, pb);
            double pm[2] = {mx, my};
            double mult = orient2d(pa, pb, pm);
            double div = (pa[0] - pb[0]) * (pa[0] - pb[0]) +
                         (pa[1] - pb[1]) * (pa[1] - pb[1]);
            if (mult != 0.0 && div != 0.0) {
                mult = mult / div;
                if (mult == mult) {
                    mx += mult * (pb[1] - pa[1]);
                    my += mult * (pa[0] - pb[0]);
                }
            }
        }
        std::vector<int> created;
        int v = add_point(m, mx, my, marker, &created, m.vtri[a],
                          ekey(a, b));
        if (v < 0) {
            if (getenv("TPUMESH_DEBUG"))
                fprintf(stderr,
                        "  split FAIL (%d,%d) at (%.9g,%.9g) split=%.4f "
                        "len=%.3e\n",
                        a, b, mx, my, split,
                        std::sqrt(dx * dx + dy * dy));
            failed_splits.insert(ekey(a, b));
            return -1;
        }
        ++n_seg_split;
        m.vtype[v] = 1;
        m.segmap.erase(ekey(a, b));
        m.segmap[ekey(a, v)] = marker;
        m.segmap[ekey(v, b)] = marker;
        segqueue.push_back(ekey(a, v));
        segqueue.push_back(ekey(v, b));
        for (int t : created) {
            if (m.tris[t].attr >= 0) queue.push_back(t);
            // re-check OTHER constrained edges on the cavity boundary:
            // the new split vertex may encroach an adjacent segment
            // (small input angles -- this is what propagates triangle's
            // concentric-shell cascade from one segment to the next)
            for (int i = 0; i < 3; ++i) {
                int ea = m.tris[t].v[(i + 1) % 3];
                int eb = m.tris[t].v[(i + 2) % 3];
                uint64_t key = ekey(ea, eb);
                if (m.segmap.count(key) && !m.is_protected(key))
                    segqueue.push_back(key);
            }
        }
        return v;
    };

    size_t iterations = 0;
    const size_t maxiter = 80u * 1000u * 1000u;
    const bool dbg = getenv("TPUMESH_DEBUG") != nullptr;

    // Scan the insertion neighborhood of p for a constrained edge whose
    // diametral lens contains p. Returns the edge key or 0.
    auto find_encroached = [&](double ix, double iy, int tc) -> uint64_t {
        std::vector<int> st{tc};
        std::unordered_set<int> seen{tc};
        double p[2] = {ix, iy};
        while (!st.empty()) {
            int tt = st.back();
            st.pop_back();
            for (int i = 0; i < 3; ++i) {
                int a = m.tris[tt].v[(i + 1) % 3];
                int b = m.tris[tt].v[(i + 2) % 3];
                int nt = m.tris[tt].n[i];
                if (m.is_constrained(a, b)) {
                    if (in_diametral(m, a, b, ix, iy)) return ekey(a, b);
                } else if (nt >= 0 && !seen.count(nt) &&
                           m.incircle_tri(nt, p) > 0.0) {
                    seen.insert(nt);
                    st.push_back(nt);
                }
            }
        }
        return 0;
    };

    // centroid fallback for area-driven splits whose circumcenter is
    // blocked (escapes the region or encroaches a protected segment): the
    // centroid is always strictly inside the triangle, so insertion cannot
    // leak across constraints. Without this, "-Y" meshes keep arbitrarily
    // large triangles next to curved protected boundaries. The centroid
    // must still respect segment encroachment (else near-boundary points
    // accumulate that quality refinement can never clean up): split the
    // offending non-protected segment instead.
    auto insert_centroid = [&](int t) {
        double gx = (m.px[m.tris[t].v[0]] + m.px[m.tris[t].v[1]] +
                     m.px[m.tris[t].v[2]]) / 3.0;
        double gy = (m.py[m.tris[t].v[0]] + m.py[m.tris[t].v[1]] +
                     m.py[m.tris[t].v[2]]) / 3.0;
        uint64_t enck = find_encroached(gx, gy, t);
        if (enck && !m.is_protected(enck)) {
            int a = int(enck >> 32), b = int(enck & 0xffffffffu);
            if (split_segment(a, b) >= 0) queue.push_back(t);
            return -1;
        }
        std::vector<int> created;
        int v = add_point(m, gx, gy, 0, &created, t);
        if (v >= 0) ++n_centroid;
        if (v >= 0)
            for (int tt : created)
                if (m.tris[tt].attr >= 0) queue.push_back(tt);
        return v;
    };

    for (int sweep = 0; sweep < 8; ++sweep) {
    while ((!pqueue.empty() || !segqueue.empty()) && ++iterations < maxiter) {
        if (dbg_counts && iterations % 65536 == 0)
            fprintf(stderr,
                    "hb iter=%zu pq=%zu sq=%zu verts=%zu last=(%.9g,%.9g)\n",
                    iterations, pqueue.size(), segqueue.size(), m.px.size(),
                    m.px.back(), m.py.back());
        if (dbg_counts && iterations % 1000000 == 0)
            fprintf(stderr,
                    "tpumesh refine progress: iter=%zuM angle=%zu area=%zu "
                    "segsplit=%zu chewdel=%zu verts=%zu pq=%zu sq=%zu\n",
                    iterations / 1000000, n_angle_ins, n_area_ins,
                    n_seg_split, n_chew_del, m.px.size(), pqueue.size(),
                    segqueue.size());
        if (!segqueue.empty()) {
            uint64_t key = segqueue.front();
            segqueue.pop_front();
            if (!m.segmap.count(key)) continue;
            int a = int(key >> 32), b = int(key & 0xffffffffu);
            int ap1, ap2;
            if (!seg_adjacent_ok(a, b, ap1, ap2)) continue;
            bool enc = false;
            for (int apex : {ap1, ap2})
                if (apex >= 0 &&
                    in_diametral(m, a, b, m.px[apex], m.py[apex]))
                    enc = true;
            static const char *sd = getenv("TPUMESH_SEGDBG");
            if (sd && m.segmap[key] == atoi(sd)) {
                double dx = m.px[a] - m.px[b], dy = m.py[a] - m.py[b];
                fprintf(stderr,
                        "segdbg pop (%d,%d) len=%.4f ap1=%d ap2=%d enc=%d\n",
                        a, b, std::sqrt(dx * dx + dy * dy), ap1, ap2, enc);
            }
            if (enc) split_segment(a, b);
            continue;
        }

        auto [t, tstamp] = pqueue.pop();
        if (t >= (int)m.tris.size() || m.tris[t].dead ||
            m.tris[t].stamp != tstamp || m.tris[t].attr < 0)
            continue;
        if (!givenup.empty() && givenup.count(triple_key(t)))
            continue;

        CircumData cd;
        if (!circum(m, t, cd)) continue;
        double maxarea = (m.tris[t].attr >= 1 &&
                          m.tris[t].attr <= (int)m.region_maxarea.size())
                             ? m.region_maxarea[m.tris[t].attr - 1]
                             : 0.0;
        bool bad_area = (maxarea > 0.0 && cd.area > maxarea);
        bool bad_angle = (cd.cos2opp > goodangle);
        if (bad_angle && !bad_area && mpw_skip(m, cd.se_a, cd.se_b))
            bad_angle = false;
        if (dbg)
            fprintf(stderr,
                    "pop t=%d v=(%d,%d,%d) area=%g badA=%d badQ=%d cc=(%g,%g)\n",
                    t, m.tris[t].v[0], m.tris[t].v[1], m.tris[t].v[2],
                    cd.area, bad_area, bad_angle, cd.cx, cd.cy);
        if (!bad_area && !bad_angle) continue;

        double ix = cd.cx, iy = cd.cy;
        if (bad_angle && !bad_area) {
            // off-center point (Ungor): stop along the bisector where the
            // new triangle is just-good
            double mx = 0.5 * (m.px[cd.se_a] + m.px[cd.se_b]);
            double my = 0.5 * (m.py[cd.se_a] + m.py[cd.se_b]);
            double dx = cd.cx - mx, dy = cd.cy - my;
            double dlen = std::sqrt(dx * dx + dy * dy);
            double ell = std::sqrt(cd.shortest2);
            // Apex height: Ungor's constant as tuned by Shewchuk
            // (triangle.c:3549, offconstant = 0.475 sqrt((1+cos q)/(1-cos
            // q))). This sits ~5% BELOW the exact at-the-bound height
            // h = ell (beta + sqrt(beta^2 - 1/4)), beta = 1/(2 sin q):
            // the new triangle is strictly better than the quality bound,
            // so it cannot be re-flagged bad by roundoff. At 33 deg the
            // exact-threshold placement re-refines borderline triangles
            // in cascades and costs ~60% extra points on motor
            // geometries (measured: 16.1k -> 10.1k on the antiperiodic
            // flux PSLG).
            double cosq = std::cos(m.minangle * M_PI / 180.0);
            double off = ell * 0.475 *
                         std::sqrt((1.0 + cosq) /
                                   std::fmax(1.0 - cosq, 1e-30));
            if (dlen > off && dlen > 0.0) {
                ix = mx + dx / dlen * off;
                iy = my + dy / dlen * off;
            }
        }

        double p[2] = {ix, iy};
        int onedge = -1;
        int tc = locate(m, p, onedge, t);
        if (tc < 0 || m.tris[tc].dead || m.tris[tc].attr != m.tris[t].attr) {
            // The proposed point escaped the region: the walk toward it
            // crossed a constrained edge. Triangle queues that BLOCKING
            // subsegment for splitting unconditionally (insertvertex
            // returns VIOLATINGVERTEX when the location walk exits
            // through a subsegment, triangle.c:8309-8344) -- this is the
            // mechanism that grades hole/interface boundaries down to
            // the local feature size. Walk from t toward the point and
            // split the first constrained edge crossed.
            bool acted = false;
            {
                int cur = t, prev = -2, guard = 0;  // -2: "no neighbor"
                                                    // (-1) must not match
                while (guard++ < 4096) {
                    int cross = -1;
                    double worst = 0.0;
                    for (int i = 0; i < 3; ++i) {
                        int a = m.tris[cur].v[(i + 1) % 3];
                        int b = m.tris[cur].v[(i + 2) % 3];
                        double o = m.orient_pt(a, b, p);
                        if (o < worst && m.tris[cur].n[i] != prev) {
                            worst = o;
                            cross = i;
                        }
                    }
                    if (cross < 0) break;   // reached p without a blocker
                    int a = m.tris[cur].v[(cross + 1) % 3];
                    int b = m.tris[cur].v[(cross + 2) % 3];
                    if (m.is_constrained(a, b)) {
                        if (split_segment(a, b) >= 0) {
                            queue.push_back(t);
                            acted = true;
                        }
                        break;
                    }
                    int nt = m.tris[cur].n[cross];
                    if (nt < 0 || m.tris[nt].dead) break;
                    prev = cur;
                    cur = nt;
                }
            }
            if (dbg && !acted)
                fprintf(stderr, "  escape NO-BLOCKER t=%d -> drop\n", t);
            if (!acted && bad_area) insert_centroid(t);
            continue;
        }

        // Pre-insertion lens scan for quality (non-area) proposals, two
        // cases only:
        //  * PROTECTED ("-Y") segments: skip the proposal outright. The
        //    star-based post-check below would reject it anyway
        //    (give-up), but the undo's cavity refill is not guaranteed
        //    to reproduce the pre-insertion triangulation exactly, so a
        //    pure insert-then-undo protocol perturbs the neighborhood
        //    it restores; skipping up front leaves the mesh untouched
        //    (~3-4% fewer nodes on the periodic-boundary fixtures).
        //  * Splittable segments at the proposal's own scale, or inside
        //    area-bounded regions: split preemptively (details below).
        // Everything else follows Triangle's lazy protocol -- rejecting
        // a point for a lens hit outside its own star splits boundary
        // segments Triangle would never split (one extra generation of
        // boundary subdivision; 2x total points on a square with one
        // short interior segment).
        if (!bad_area) {
            bool prot_enc = false;
            uint64_t short_enc = 0;
            std::vector<int> st{tc};
            std::unordered_set<int> seen{tc};
            while (!st.empty() && !prot_enc) {
                int tt = st.back();
                st.pop_back();
                for (int i = 0; i < 3; ++i) {
                    int a = m.tris[tt].v[(i + 1) % 3];
                    int b = m.tris[tt].v[(i + 2) % 3];
                    int nt = m.tris[tt].n[i];
                    if (m.is_constrained(a, b)) {
                        if (!in_diametral(m, a, b, ix, iy)) continue;
                        if (m.is_protected(ekey(a, b))) {
                            prot_enc = true;
                            break;
                        }
                        // LOCAL-SCALE segments only (|s|^2 <= 4 r^2 of
                        // the proposal): split preemptively instead of
                        // inserting -- on discretized arcs this redirects
                        // the point budget into the chain, measurably
                        // denser otherwise. LONG segments are left to the
                        // star-based post-check (Triangle's lazy
                        // protocol): a long boundary edge's lens covers
                        // much of the domain, and splitting it for every
                        // interior proposal costs an extra generation of
                        // boundary subdivision (2x points on a square
                        // with one short interior segment).
                        static const double kShortSegC = []() {
                            const char *e = getenv("TPUMESH_SHORTSEG_C");
                            return e ? atof(e) : 4.0;
                        }();
                        double sdx = m.px[a] - m.px[b],
                               sdy = m.py[a] - m.py[b];
                        // In area-bounded regions (every .fem region) the
                        // boundary is refined to the area scale anyway,
                        // so preemptive splitting just aligns points onto
                        // the constraint instead of leaving free points
                        // straddling it -- measurably fewer nodes on the
                        // motor/Temp fixtures. Scale-free regions keep
                        // the lazy star-only protocol.
                        if ((maxarea > 0.0 ||
                             sdx * sdx + sdy * sdy <= kShortSegC * cd.r2) &&
                            !short_enc)
                            short_enc = ekey(a, b);
                    } else if (nt >= 0 && !seen.count(nt) &&
                               m.incircle_tri(nt, p) > 0.0) {
                        seen.insert(nt);
                        st.push_back(nt);
                    }
                }
            }
            if (prot_enc) continue;
            if (short_enc) {
                int a = int(short_enc >> 32), b = int(short_enc & 0xffffffffu);
                int sv = split_segment(a, b);
                if (dbg)
                    fprintf(stderr, "  enc short seg (%d,%d) -> split v=%d\n",
                            a, b, sv);
                if (sv >= 0) queue.push_back(t);
                continue;
            }
        }

        // key the proposal by t's vertex triple NOW: the insertion below
        // kills t (it is part of the new vertex's cavity) and its slot
        // may be recycled by the time the undo path needs the key
        const uint64_t proposal_key = triple_key(t);
        std::vector<int> created;
        int v = add_point(m, ix, iy, 0, &created, tc);
        if (dbg) fprintf(stderr, "  insert (%g,%g) -> v=%d\n", ix, iy, v);
        if (v < 0) {
            // Proposal landed ON a constrained edge (near-degenerate
            // slivers at corners do this): triangle returns
            // VIOLATINGVERTEX and queues that subsegment for splitting
            // (triangle.c:8309-8344) rather than dropping the triangle.
            if (onedge >= 0) {
                int a = m.tris[tc].v[(onedge + 1) % 3];
                int b = m.tris[tc].v[(onedge + 2) % 3];
                uint64_t key = ekey(a, b);
                if (m.segmap.count(key) && !m.is_protected(key) &&
                    split_segment(a, b) >= 0) {
                    queue.push_back(t);
                    continue;
                }
            }
            if (bad_area) insert_centroid(t);
            continue;
        }
        // Post-insertion encroachment check -- Triangle's ONLY rejection
        // mechanism for quality points (insertvertex flip loop,
        // triangle.c:8612-8625 + splittriangle ENCROACHINGVERTEX undo,
        // triangle.c:13597-13604): the new vertex is the apex opposite
        // every cavity-boundary edge; if one of those edges is a
        // constrained segment whose diametral lens holds the vertex,
        // reject the insertion (undo) and split that segment instead.
        // Deliberately NO broader pre-insertion lens scan: rejecting a
        // point because it falls in the lens of some segment NOT on its
        // own star splits boundary segments Triangle would never split,
        // and costs one extra generation of boundary subdivision
        // (measured 2x total points on a square with one short interior
        // segment, 116 vs Triangle's 57).
        {
            uint64_t badkey = 0;
            bool badprot = false;
            for (int tt : created) {
                int iv = m.vidx(tt, v);
                if (iv < 0) continue;
                int a = m.tris[tt].v[(iv + 1) % 3];
                int b = m.tris[tt].v[(iv + 2) % 3];
                uint64_t key = ekey(a, b);
                if (!m.segmap.count(key)) continue;
                // checkseg4encroach tests BOTH flanking apexes
                // (triangle.c:7155-7204); v is one, the far side's apex
                // is the other
                bool enc = in_diametral(m, a, b, m.px[v], m.py[v]);
                if (!enc) {
                    int ot = m.tris[tt].n[iv];
                    if (ot >= 0 && !m.tris[ot].dead) {
                        int ia = m.vidx(ot, b);   // apex opposite (b,a)
                        int ap = -1;
                        for (int j = 0; j < 3; ++j) {
                            int u = m.tris[ot].v[j];
                            if (u != a && u != b) ap = u;
                        }
                        (void)ia;
                        if (ap >= 0)
                            enc = in_diametral(m, a, b, m.px[ap], m.py[ap]);
                    }
                }
                if (enc) {
                    badkey = key;
                    badprot = m.is_protected(key);
                    break;
                }
            }
            // Protected ("-Y") segments cannot be split: keep area-driven
            // points (area bounds must stay satisfiable next to protected
            // curved boundaries), reject angle-driven ones outright
            // (Triangle under -Y rejects the vertex and gives up on the
            // skinny triangle: checkseg4encroach returns encroached
            // without queueing, triangle.c:7205-7227).
            if (badkey && !(badprot && bad_area)) {
                std::vector<int> refill;
                if (delete_free_vertex(m, v, &refill)) {
                    int a = int(badkey >> 32), b = int(badkey & 0xffffffffu);
                    for (int tt : refill)
                        if (m.tris[tt].attr >= 0) queue.push_back(tt);
                    bool split_ok =
                        !badprot && split_segment(a, b) >= 0;
                    if (dbg)
                        fprintf(stderr,
                                "  undo v=%d, enc seg (%d,%d)%s%s\n", v, a,
                                b, badprot ? " [protected]" : "",
                                split_ok ? "" : " [giveup]");
                    // If the segment cannot be split (protected, or the
                    // split failed) this proposal can never succeed:
                    // remember the triple so the restored triangle is
                    // not retried forever.
                    if (!split_ok) givenup.insert(proposal_key);
                    continue;
                }
            }
        }
        if (bad_area) ++n_area_ins; else ++n_angle_ins;
        for (int tt : created) {
            if (m.tris[tt].attr >= 0) queue.push_back(tt);
            // Re-check cavity-boundary subsegments for encroachment by
            // their (possibly changed) apexes: triangle's insertvertex
            // runs checkseg4encroach on every subsegment bounding the
            // cavity (triangle.c:8471+), which is what keeps thin-gap
            // chords split as finely as the surrounding refinement.
            // Lazy: just queue them; the segqueue pop re-verifies.
            for (int i = 0; i < 3; ++i) {
                int a = m.tris[tt].v[(i + 1) % 3];
                int b = m.tris[tt].v[(i + 2) % 3];
                uint64_t key = ekey(a, b);
                if (m.segmap.count(key) && !m.is_protected(key))
                    segqueue.push_back(key);
            }
        }
    }
    // Verification re-scan: queue bookkeeping across deletions/undos is
    // intricate; rather than prove every path re-queues, re-scan all
    // live triangles and re-drain until the mesh is verifiably clean
    // (normally converges on the first re-scan with nothing found).
    if (iterations >= maxiter) break;
    for (int t = 0; t < (int)m.tris.size(); ++t)
        if (!m.tris[t].dead && m.tris[t].attr >= 0) queue_push(t);
    if (pqueue.empty() && segqueue.empty()) break;
    }
    if (dbg_counts)
        fprintf(stderr,
                "tpumesh refine: angle=%zu area=%zu centroid=%zu "
                "segsplit=%zu chewdel=%zu iter=%zu\n",
                n_angle_ins, n_area_ins, n_centroid, n_seg_split,
                n_chew_del, iterations);
}

}  // namespace

// ===================================================================== //
// C ABI                                                                 //
// ===================================================================== //

extern "C" {

// Returns 0 on success; nonzero codes: 1 bad input, 2 internal location
// failure, 3 constraint recovery failure, 4 classification failure.
// flags: bit0 = suppress boundary Steiner points (-Y),
//        bit1 = prune unused vertices (-j).
int tpumesh_triangulate(
    int npoints, const double *pts, const int *ptmarkers,
    int nsegs, const int *segs, const int *segmarkers,
    int nholes, const double *holes,
    int nregions, const double *regions,  // x,y,attr,maxarea per region
    double minangle, int flags,
    int *out_npoints, double **out_pts, int **out_ptmarkers,
    int *out_ntris, int **out_tris, int **out_triattrs,
    int *out_nedges, int **out_edges, int **out_edgemarkers,
    int **out_vertexmap) {
    if (npoints < 3) return 1;

    Mesh m;
    m.minangle = minangle;
    m.no_boundary_steiner = (flags & 1) != 0;

    double lox = pts[0], hix = pts[0], loy = pts[1], hiy = pts[1];
    for (int i = 1; i < npoints; ++i) {
        lox = std::fmin(lox, pts[2 * i]);
        hix = std::fmax(hix, pts[2 * i]);
        loy = std::fmin(loy, pts[2 * i + 1]);
        hiy = std::fmax(hiy, pts[2 * i + 1]);
    }
    double w = std::fmax(hix - lox, hiy - loy);
    if (w == 0) w = 1.0;
    double cx = 0.5 * (lox + hix), cy = 0.5 * (loy + hiy);
    double R = 64.0 * w;

    // dedup exactly-equal input points (reference -j semantics)
    std::vector<int> vmap(npoints, -1);
    {
        struct XY {
            double x, y;
            bool operator==(const XY &o) const {
                return x == o.x && y == o.y;
            }
        };
        struct XYh {
            size_t operator()(const XY &p) const {
                uint64_t a, b;
                std::memcpy(&a, &p.x, 8);
                std::memcpy(&b, &p.y, 8);
                return size_t(a * 1000003u ^ (b + 0x9e3779b97f4a7c15ull));
            }
        };
        std::unordered_map<XY, int, XYh> seen;
        for (int i = 0; i < npoints; ++i) {
            XY p{pts[2 * i], pts[2 * i + 1]};
            auto it = seen.find(p);
            if (it != seen.end()) {
                vmap[i] = it->second;
                continue;
            }
            vmap[i] = m.addv(p.x, p.y, ptmarkers ? ptmarkers[i] : 0);
            seen.emplace(p, vmap[i]);
        }
    }
    int ninput = int(m.px.size());
    int s0 = m.addv(cx - 2.0 * R, cy - R, 0);
    int s1 = m.addv(cx + 2.0 * R, cy - R, 0);
    int s2 = m.addv(cx, cy + 2.0 * R, 0);
    m.nsuper0 = ninput;
    m.newtri(s0, s1, s2, 0);

    for (int i = 0; i < ninput; ++i) {
        double p[2] = {m.px[i], m.py[i]};
        int onedge = -1;
        int t = locate(m, p, onedge);
        if (t < 0) return 2;
        insert_vertex(m, i, t, onedge);
    }

    for (int i = 0; i < nsegs; ++i) {
        int a = vmap[segs[2 * i]], b = vmap[segs[2 * i + 1]];
        if (a == b) continue;
        if (!recover_segment(m, a, b, segmarkers ? segmarkers[i] : 0)) {
            if (getenv("TPUMESH_DEBUG"))
                fprintf(stderr,
                        "constraint recovery failed: seg %d (%d,%d) "
                        "(%g,%g)-(%g,%g)\n",
                        i, a, b, m.px[a], m.py[a], m.px[b], m.py[b]);
            return 3;
        }
    }

    for (auto &t : m.tris)
        if (!t.dead) t.attr = INT32_MIN;
    for (int t = 0; t < (int)m.tris.size(); ++t) {
        if (m.tris[t].dead || m.tris[t].attr != INT32_MIN) continue;
        bool touches_super = false;
        for (int i = 0; i < 3; ++i)
            if (m.tris[t].v[i] >= m.nsuper0) touches_super = true;
        if (touches_super) flood(m, t, -1);
    }
    for (int h = 0; h < nholes; ++h) {
        double p[2] = {holes[2 * h], holes[2 * h + 1]};
        int onedge = -1;
        int t = locate(m, p, onedge);
        if (t >= 0 && m.tris[t].attr == INT32_MIN) flood(m, t, -1);
    }
    int maxattr = 0;
    for (int r = 0; r < nregions; ++r)
        maxattr = std::max(maxattr, int(regions[4 * r + 2]));
    m.region_maxarea.assign(maxattr, 0.0);
    for (int r = 0; r < nregions; ++r) {
        double p[2] = {regions[4 * r], regions[4 * r + 1]};
        int attr = int(regions[4 * r + 2]);
        if (attr >= 1) m.region_maxarea[attr - 1] = regions[4 * r + 3];
        int onedge = -1;
        int t = locate(m, p, onedge);
        if (t >= 0 && m.tris[t].attr == INT32_MIN) flood(m, t, attr);
    }
    // enclosed regions without a region marker stay meshed with attr 0
    // (the solver maps them to the problem's default block label, like
    // triangle's unmarked regions + fsolver.cpp:541-562)
    for (auto &t : m.tris)
        if (!t.dead && t.attr == INT32_MIN) t.attr = 0;
    for (int t = 0; t < (int)m.tris.size(); ++t)
        if (!m.tris[t].dead && m.tris[t].attr < 0) m.killtri(t);
    // vtri pointers and neighbor links may now reference dead triangles
    // (whose slots the freelist will recycle): rebuild/clear them
    std::fill(m.vtri.begin(), m.vtri.end(), -1);
    for (int t = 0; t < (int)m.tris.size(); ++t) {
        if (m.tris[t].dead) continue;
        for (int i = 0; i < 3; ++i) {
            m.vtri[m.tris[t].v[i]] = t;
            int nt = m.tris[t].n[i];
            if (nt >= 0 && m.tris[nt].dead) m.tris[t].n[i] = -1;
        }
    }
    m.last_tri = -1;

    // "-Y": protect exterior/hole-boundary segments (those with fewer than
    // two live adjacent triangles) from splitting; interior constrained
    // segments stay refinable, matching triangle's -Y semantics.
    if (m.no_boundary_steiner) {
        for (auto &kv : m.segmap) {
            int a = int(kv.first >> 32), b = int(kv.first & 0xffffffffu);
            int t, i, count = 0;
            if (m.find_edge(a, b, t, i)) ++count;
            if (m.find_edge(b, a, t, i)) ++count;
            if (count < 2) m.protected_segs.insert(kv.first);
        }
    }

    m.n_input = (int)m.px.size();
    std::fill(m.vtype.begin(), m.vtype.end(), uint8_t(0));
    refine(m);

    // ---- sliver cleanup ----
    // Delaunay flips can legally recreate a chord triangle across a split
    // constraint midpoint that rounded a hair off the exact line (area
    // ~1e-20); quality refinement skips such triangles (their circumcenter
    // is unreachable). Flip the longest edge of catastrophically thin
    // triangles when legal; a few sweeps clear cascades.
    for (int sweep = 0; sweep < 8; ++sweep) {
        bool changed = false;
        for (int t = 0; t < (int)m.tris.size(); ++t) {
            if (m.tris[t].dead) continue;
            int va = m.tris[t].v[0], vb = m.tris[t].v[1],
                vc = m.tris[t].v[2];
            double area2 = std::fabs(m.orient(va, vb, vc));
            double lmax2 = 0.0;
            int ilong = 0;
            for (int i = 0; i < 3; ++i) {
                int a = m.tris[t].v[(i + 1) % 3];
                int b = m.tris[t].v[(i + 2) % 3];
                double dx = m.px[a] - m.px[b], dy = m.py[a] - m.py[b];
                double l2 = dx * dx + dy * dy;
                if (l2 > lmax2) {
                    lmax2 = l2;
                    ilong = i;
                }
            }
            // height of the triangle over its longest edge, squared,
            // relative to that edge: degenerate when < ~(1e-6 * edge)^2
            if (lmax2 <= 0.0 || area2 * area2 >= 1e-12 * lmax2 * lmax2 *
                                                     lmax2 / 4.0)
                continue;
            int a = m.tris[t].v[(ilong + 1) % 3];
            int b = m.tris[t].v[(ilong + 2) % 3];
            if (m.tris[t].n[ilong] < 0) {
                // zero-area flap on the hull (midpoint rounded outside
                // the original chord): remove it; the split subsegments
                // become the hull
                for (int i = 0; i < 3; ++i) {
                    int nt = m.tris[t].n[i];
                    if (nt < 0 || m.tris[nt].dead) continue;
                    for (int k = 0; k < 3; ++k)
                        if (m.tris[nt].n[k] == t) m.tris[nt].n[k] = -1;
                    for (int k = 0; k < 3; ++k)
                        m.vtri[m.tris[nt].v[k]] = nt;
                }
                m.killtri(t);
                changed = true;
                continue;
            }
            if (m.is_constrained(a, b)) continue;
            if (flip_edge(m, t, ilong)) changed = true;
        }
        if (!changed) break;
    }

    // ---- outputs ----
    int nverts = int(m.px.size());
    std::vector<char> used(nverts, 0);
    for (auto &t : m.tris)
        if (!t.dead)
            for (int i = 0; i < 3; ++i) used[t.v[i]] = 1;
    bool prune = (flags & 2) != 0;
    std::vector<int> newid(nverts, -1);
    int nout = 0;
    for (int v = 0; v < nverts; ++v) {
        bool is_super = (v >= m.nsuper0 && v < m.nsuper0 + 3);
        if (is_super) {
            if (used[v]) {
                if (getenv("TPUMESH_DEBUG")) {
                    for (int t = 0; t < (int)m.tris.size(); ++t)
                        if (!m.tris[t].dead && m.vidx(t, v) >= 0)
                            fprintf(stderr,
                                    "super v%d in tri %d (%d,%d,%d) attr %d\n",
                                    v, t, m.tris[t].v[0], m.tris[t].v[1],
                                    m.tris[t].v[2], m.tris[t].attr);
                }
                return 4;
            }
            continue;
        }
        if (m.vdead[v]) continue;        // removed by Chew's deletion
        if (prune && !used[v]) continue;
        newid[v] = nout++;
    }

    *out_npoints = nout;
    *out_pts = (double *)malloc(sizeof(double) * 2 * nout);
    *out_ptmarkers = (int *)malloc(sizeof(int) * nout);
    for (int v = 0; v < nverts; ++v) {
        int nv = newid[v];
        if (nv < 0) continue;
        (*out_pts)[2 * nv] = m.px[v];
        (*out_pts)[2 * nv + 1] = m.py[v];
        (*out_ptmarkers)[nv] = m.vmark[v];
    }
    *out_vertexmap = (int *)malloc(sizeof(int) * npoints);
    for (int i = 0; i < npoints; ++i)
        (*out_vertexmap)[i] = newid[vmap[i]];

    int ntris = 0;
    for (auto &t : m.tris)
        if (!t.dead) ++ntris;
    *out_ntris = ntris;
    *out_tris = (int *)malloc(sizeof(int) * 3 * ntris);
    *out_triattrs = (int *)malloc(sizeof(int) * ntris);
    {
        int k = 0;
        for (auto &t : m.tris) {
            if (t.dead) continue;
            for (int i = 0; i < 3; ++i) (*out_tris)[3 * k + i] = newid[t.v[i]];
            (*out_triattrs)[k] = t.attr;
            ++k;
        }
    }

    std::unordered_map<uint64_t, int> edgeset;
    for (auto &t : m.tris) {
        if (t.dead) continue;
        for (int i = 0; i < 3; ++i) {
            int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
            uint64_t k = ekey(a, b);
            if (edgeset.count(k)) continue;
            auto it = m.segmap.find(k);
            edgeset[k] = (it != m.segmap.end()) ? it->second : 0;
        }
    }
    *out_nedges = int(edgeset.size());
    *out_edges = (int *)malloc(sizeof(int) * 2 * edgeset.size());
    *out_edgemarkers = (int *)malloc(sizeof(int) * edgeset.size());
    {
        int k = 0;
        for (auto &kv : edgeset) {
            int a = int(kv.first >> 32), b = int(kv.first & 0xffffffffu);
            (*out_edges)[2 * k] = newid[a];
            (*out_edges)[2 * k + 1] = newid[b];
            (*out_edgemarkers)[k] = kv.second;
            ++k;
        }
    }
    return 0;
}

void tpumesh_free(void *p) { free(p); }
int tpumesh_version() { return 1; }

}  // extern "C"
