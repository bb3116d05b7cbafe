"""Interactive HTML visualization of embeddings.

Counterpart of graph_embed_tpu/viz.py, numpy and json only, so the same
inputs give the same bytes.  It replaces the reference's plotly-2 script
(scripts/plot-graph.py, run by examples/embedder.cpp:291-293): a
self-contained HTML file with an inline canvas 3D renderer (drag to
rotate, wheel to zoom).  Colours follow the reference's scheme
(scripts/plot-graph.py:92-111): the coarsest aggregates take evenly spaced
hues, and each finer level jitters its parent's colour by +-0.01.
"""

from __future__ import annotations

import colorsys
import json

import numpy as np


def vertex_colors(level_assignments, n, *, jitter=0.01, seed=0):
    """Per-vertex RGB using the reference's coarse-base + jitter scheme."""
    rng = np.random.default_rng(seed)
    assigns = [np.asarray(a) for a in level_assignments]
    if not assigns:
        return np.tile([[0.2, 0.4, 0.8]], (n, 1))
    # compose original-vertex -> each level's aggregate id
    composed = [assigns[0]]
    for a in assigns[1:]:
        composed.append(a[composed[-1]])
    m_top = int(composed[-1].max()) + 1
    hues = np.linspace(0.0, 1.0, m_top, endpoint=False)
    base = np.array([colorsys.hsv_to_rgb(h, 0.85, 0.9) for h in hues])
    color = base[composed[-1]]                       # [n, 3] coarsest colors
    for comp in reversed(composed[:-1]):
        m = int(comp.max()) + 1
        jit = rng.uniform(-jitter, jitter, size=(m, 3))
        color = np.clip(color + jit[comp], 0.0, 1.0)
    return color


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>graph-embed-tpu</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:sans-serif}
#c{display:block}#hud{position:fixed;top:8px;left:8px;font-size:12px}</style>
</head><body>
<div id="hud">drag: rotate &middot; wheel: zoom &middot; %(n)d vertices, %(e)d edges</div>
<canvas id="c"></canvas>
<script>
const V=%(verts)s, E=%(edges)s, C=%(colors)s;
const cv=document.getElementById('c'),cx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
let ax=0.4,ay=0.6,zoom=0.8,drag=0,px=0,py=0;
addEventListener('resize',rs);
cv.addEventListener('mousedown',e=>{drag=1;px=e.clientX;py=e.clientY;});
addEventListener('mouseup',()=>drag=0);
addEventListener('mousemove',e=>{if(!drag)return;ay+=(e.clientX-px)*0.008;
ax+=(e.clientY-py)*0.008;px=e.clientX;py=e.clientY;draw();});
cv.addEventListener('wheel',e=>{zoom*=e.deltaY<0?1.1:0.9;draw();e.preventDefault();});
function proj(p){
 const ca=Math.cos(ax),sa=Math.sin(ax),cb=Math.cos(ay),sb=Math.sin(ay);
 let x=p[0],y=p[1],z=p[2]||0;
 let x1=cb*x+sb*z, z1=-sb*x+cb*z;
 let y1=ca*y-sa*z1, z2=sa*y+ca*z1;
 const s=Math.min(W,H)*0.45*zoom;
 return [W/2+x1*s, H/2-y1*s, z2];}
function draw(){
 cx.fillStyle='#111';cx.fillRect(0,0,W,H);
 cx.strokeStyle='rgba(160,160,160,0.25)';cx.lineWidth=0.5;
 cx.beginPath();
 for(const [i,j] of E){const a=proj(V[i]),b=proj(V[j]);
  cx.moveTo(a[0],a[1]);cx.lineTo(b[0],b[1]);}
 cx.stroke();
 for(let i=0;i<V.length;i++){const p=proj(V[i]);const c=C[i];
  cx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
  cx.beginPath();cx.arc(p[0],p[1],%(r).1f,0,6.283);cx.fill();}
}
rs();
</script></body></html>
"""


def write_embedding_html(coords, edges, path, *, level_assignments=None,
                         max_edges: int = 200_000, point_radius: float = 2.5,
                         max_points: int = 500_000):
    """Write a standalone interactive HTML plot.

    coords: [n, 2|3]; edges: (senders, receivers) arrays;
    level_assignments: optional hierarchy for the reference coloring scheme.
    Layouts beyond ``max_points`` vertices are uniformly subsampled (edges
    keep only endpoints that survive) -- the scale runs produce multi-
    million-vertex layouts, and an HTML embedding 16.8M points is ~1GB of
    JSON no browser opens; 500k points render fine and preserve the
    community/ball structure the plot exists to show.
    """
    if hasattr(coords, "detach"):
        coords = coords.detach().cpu().numpy()
    coords = np.asarray(coords, dtype=np.float64)
    n_full = coords.shape[0]
    s, r = edges
    s, r = np.asarray(s), np.asarray(r)
    la = list(level_assignments) if level_assignments else None
    if n_full > max_points:
        pick = np.sort(np.random.default_rng(0).choice(
            n_full, max_points, replace=False))
        remap = np.full(n_full, -1, np.int64)
        remap[pick] = np.arange(max_points)
        coords = coords[pick]
        ekeep = (remap[s] >= 0) & (remap[r] >= 0)
        s, r = remap[s[ekeep]], remap[r[ekeep]]
        if la:
            # only level 0 is per-vertex; higher levels map aggregate ids
            # (which subsampling leaves untouched)
            la = [np.asarray(la[0])[pick]] + [np.asarray(a)
                                             for a in la[1:]]
    n = coords.shape[0]
    if coords.shape[1] == 2:
        coords = np.concatenate([coords, np.zeros((n, 1))], axis=1)
    # normalize into [-1, 1]^3 for the viewer
    c = coords - coords.mean(axis=0, keepdims=True)
    scale = np.abs(c).max() or 1.0
    c = c / scale
    keep = s < r
    s, r = s[keep], r[keep]
    if s.size > max_edges:
        idx = np.random.default_rng(0).choice(s.size, max_edges, replace=False)
        s, r = s[idx], r[idx]
    if la:
        col = vertex_colors(la, n)
    else:
        col = np.tile([[0.35, 0.6, 0.95]], (n, 1))
    col255 = (col * 255).astype(int)
    html = _HTML_TEMPLATE % {
        "n": n, "e": int(s.size), "r": point_radius,
        "verts": json.dumps(np.round(c, 4).tolist()),
        "edges": json.dumps(np.stack([s, r], axis=1).tolist()),
        "colors": json.dumps(col255.tolist()),
    }
    with open(path, "w") as f:
        f.write(html)


def plot_graph_html(matpath, partpath, coordspath, outpath):
    """File-based interface matching scripts/plot-graph.py's CLI contract
    (``-graph -part -coords -o``): edge list + multilevel partition file +
    coords file -> HTML."""
    edges = np.loadtxt(matpath, dtype=np.int64, ndmin=2)
    coords = np.loadtxt(coordspath, dtype=np.float64, ndmin=2)
    level_assignments = _read_multilevel_partition(partpath)
    write_embedding_html(coords, (edges[:, 0], edges[:, 1]), outpath,
                         level_assignments=level_assignments)


def _read_multilevel_partition(path):
    """Parse the embedder pipeline's part.temp format
    (examples/embedder.cpp:230-267): 'n k' header, per-level aggregate
    counts, then per level one member line per aggregate."""
    with open(path) as f:
        n, k = (int(x) for x in f.readline().split())
        counts = [int(x) for x in f.readline().split()]
        assigns = []
        prev_n = n
        for lvl in range(k):
            m = counts[lvl]
            assign = np.zeros(prev_n, dtype=np.int64)
            for a in range(m):
                toks = f.readline().split()
                for t in toks:
                    assign[int(t)] = a
            assigns.append(assign)
            prev_n = m
    return assigns
