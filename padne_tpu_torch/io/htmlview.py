"""Self-contained HTML/WebGL solution viewer export.

Writes ONE .html file embedding the solution's meshes and fields
(base64 float32 arrays) plus a small WebGL renderer: pan/zoom, layer
and mode switching, colormap legend, hover probing.  No server, no
dependencies — open in any browser.  This is the framework's
display-anywhere counterpart of the reference's Qt/OpenGL GUI.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

from .. import solver as solver_mod


def _b64(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(np.ascontiguousarray(arr, dtype=dtype).tobytes()).decode()


def _boundary_edges(tri: np.ndarray, with_tri: bool = False):
    """(k, 2) vertex-index pairs of edges used by exactly one triangle
    (the copper outline the reference GUI draws per mesh, ui.py:746-766).
    with_tri: also return the source-triangle index of each edge (the
    chunked payload assigns boundary edges to their triangle's chunk)."""
    tri = np.asarray(tri)
    if len(tri) == 0:
        empty = np.zeros((0, 2), np.uint32)
        return (empty, np.zeros(0, np.int64)) if with_tri else empty
    e = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
    src = np.tile(np.arange(len(tri), dtype=np.int64), 3)
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    k = key[order]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]).any(axis=1)
    grp = np.cumsum(new) - 1
    once = np.bincount(grp)[grp] == 1
    edges = e[order][once].astype(np.uint32)
    if with_tri:
        return edges, src[order][once]
    return edges


# Chunk vertex-count limit: u16 triangle indices address at most 65536
# local vertices; 65000 leaves headroom for the greedy batch cut.
_CHUNK_VLIMIT = 65000


def _chunk_mesh(nv: int, tris: np.ndarray, limit: int = _CHUNK_VLIMIT):
    """Split a triangle list into consecutive-range chunks whose vertex
    subsets each fit u16 indexing.

    Returns a list of (vidx, tris_local, t0, t1): global vertex ids in
    local order, (t1-t0, 3) uint16 local triangles, and the triangle
    range [t0, t1) — consecutive, so per-face values slice directly.
    A None return means no chunking is needed (nv already fits).
    """
    if nv <= limit:
        return None
    tris = np.asarray(tris)
    # A batch introduces at most 3*batch distinct vertices, so sizing
    # it from the limit guarantees no single batch can overflow a
    # chunk (an over-limit chunk would silently corrupt u16 indices).
    batch = max(1, limit // 3)
    chunks = []
    g2l = np.full(nv, -1, np.int64)
    cur_v: list = []
    cur_t: list = []
    count = 0
    t_start = 0

    def flush(t_end):
        nonlocal cur_v, cur_t, count, t_start
        vidx = np.concatenate(cur_v)
        tl = np.concatenate(cur_t).astype(np.uint16)
        chunks.append((vidx, tl, t_start, t_end))
        g2l[vidx] = -1
        cur_v, cur_t, count = [], [], 0
        t_start = t_end

    for s in range(0, len(tris), batch):
        tb = tris[s:s + batch]
        uniq = np.unique(tb)
        new = uniq[g2l[uniq] < 0]
        if count + len(new) > limit and count > 0:
            flush(s)
            new = np.unique(tb)
        g2l[new] = count + np.arange(len(new))
        count += len(new)
        cur_v.append(new)
        cur_t.append(g2l[tb])
    if count:
        flush(len(tris))
    return chunks


def _quant16(verts: np.ndarray):
    """(q_u16 (n, 2), bbox [x0, y0, x1, y1]): vertices on a 65535-step
    grid over their bbox — sub-2 µm at a 100 mm board, far below mesh
    resolution, at half the wire bytes (the VTU-appended-mode idea)."""
    v = np.asarray(verts, np.float64)
    if len(v) == 0:
        return np.zeros((0, 2), np.uint16), [0.0, 0.0, 1.0, 1.0]
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    span = np.maximum(hi - lo, 1e-30)
    q = np.round((v - lo) / span * 65535.0).astype(np.uint16)
    return q, [float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1])]


def _layer_points(problem, layer) -> np.ndarray:
    """(k, 3) connection-point markers landing on `layer`: world x, y
    plus a sourced flag (the reference draws red=sourced, gray=passive,
    ui.py:876-927, 1366-1403)."""
    pts = [
        (c.point.x, c.point.y, 1.0 if net.has_source else 0.0)
        for net in problem.networks
        for c in net.connections
        if c.layer is layer
    ]
    return np.asarray(pts, np.float32).reshape(-1, 3)


def _encode_mesh(verts, tris, vvals=None, fvals=None) -> list[dict]:
    """One mesh -> 1+ payload entries (chunked to u16 indexing).

    Wire format (v2, quantized): vertices ride as u16 grid steps over
    the mesh bbox ("vq" + "bbox"), triangle/boundary indices as u16 —
    about 2.2x smaller than the v1 float32/uint32 encoding; field
    values stay exact f32 (probe readouts keep full precision).
    """
    verts = np.asarray(verts)
    tris = np.asarray(tris)
    chunks = _chunk_mesh(len(verts), tris)
    if chunks is None:
        q, bbox = _quant16(verts)
        entry = {
            "vq": _b64(q, np.uint16), "bbox": bbox,
            "triangles": _b64(tris, np.uint16),
            "boundary": _b64(_boundary_edges(tris), np.uint16),
            "nv": int(len(verts)), "nt": int(len(tris)),
        }
        if vvals is not None:
            entry["potential"] = _b64(vvals, np.float32)
        if fvals is not None:
            entry["power"] = _b64(fvals, np.float32)
        return [entry]
    edges, srctri = _boundary_edges(tris, with_tri=True)
    out = []
    g2l = np.full(len(verts), -1, np.int64)
    for vidx, tl, t0, t1 in chunks:
        sub = verts[vidx]
        q, bbox = _quant16(sub)
        g2l[vidx] = np.arange(len(vidx))
        sel = (srctri >= t0) & (srctri < t1)
        bnd_local = g2l[edges[sel]].astype(np.uint16)
        g2l[vidx] = -1
        entry = {
            "vq": _b64(q, np.uint16), "bbox": bbox,
            "triangles": _b64(tl, np.uint16),
            "boundary": _b64(bnd_local, np.uint16),
            "nv": int(len(vidx)), "nt": int(t1 - t0),
        }
        if vvals is not None:
            entry["potential"] = _b64(np.asarray(vvals)[vidx], np.float32)
        if fvals is not None:
            entry["power"] = _b64(np.asarray(fvals)[t0:t1], np.float32)
        out.append(entry)
    return out


def _solution_payload(sol: solver_mod.Solution) -> dict:
    layers = []
    for layer, ls in zip(sol.problem.layers, sol.layer_solutions):
        meshes = []
        for mi, m in enumerate(ls.meshes):
            meshes.extend(_encode_mesh(
                m.vertices, m.triangles,
                vvals=ls.potentials[mi].values,
                fvals=(ls.power_densities[mi].values
                       if mi < len(ls.power_densities) else None),
            ))
        disc = []
        for m in ls.disconnected_meshes:
            disc.extend(_encode_mesh(m.vertices, m.triangles))
        pts = _layer_points(sol.problem, layer)
        layers.append({"name": layer.name, "meshes": meshes,
                       "disconnected": disc,
                       "points": _b64(pts, np.float32),
                       "npts": int(len(pts))})
    return {
        "project": sol.problem.project_name or "solution",
        "residual": sol.solver_info.residual_norm,
        "layers": layers,
    }


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>padne-tpu — __TITLE__</title>
<style>
 body { margin:0; font:13px system-ui, sans-serif; background:#14141a; color:#ddd; }
 #bar { padding:6px 10px; background:#20202a; display:flex; gap:14px; align-items:center; }
 #bar select, #bar button { background:#2e2e3a; color:#ddd; border:1px solid #444; padding:3px 8px; border-radius:4px; }
 #c { display:block; width:100vw; height:calc(100vh - 60px); }
 #legend { padding:2px 10px; background:#20202a; display:flex; gap:10px; align-items:center; height:22px;}
 #grad { width:220px; height:12px; border:1px solid #555; }
 #probe { margin-left:auto; opacity:.9 }
</style></head><body>
<div id="bar">
 <b>padne-tpu</b> <span>__TITLE__</span>
 <label>layer <select id="layer"></select></label>
 <label>mode <select id="mode"><option>Potential</option><option>Power density</option></select></label>
 <label><input type="checkbox" id="edges"> edges</label>
 <label><input type="checkbox" id="boundary"> boundary</label>
 <label><input type="checkbox" id="points" checked> points</label>
 <label>min <input id="vmin_in" size="9"></label>
 <label>max <input id="vmax_in" size="9"></label>
 <button id="rescale">apply scale</button>
 <button id="reset">reset view</button>
 <span style="opacity:.6">residual __RESID__</span>
</div>
<div id="legend"><canvas id="grad" width="220" height="12"></canvas>
 <span id="vmin"></span><span>…</span><span id="vmax"></span>
 <span id="vdelta" style="opacity:.7"></span>
 <span id="probe"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
function decode(b64, T){ const s=atob(b64); const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++) a[i]=s.charCodeAt(i); return new T(a.buffer); }
function dequant(q, bbox){ const n=q.length/2; const v=new Float32Array(2*n);
  const sx=(bbox[2]-bbox[0])/65535.0, sy=(bbox[3]-bbox[1])/65535.0;
  for(let i=0;i<n;i++){ v[2*i]=bbox[0]+q[2*i]*sx; v[2*i+1]=bbox[1]+q[2*i+1]*sy; }
  return v; }
for (const L of DATA.layers){
  for (const m of L.meshes){
    m.v = dequant(decode(m.vq, Uint16Array), m.bbox);
    m.t = decode(m.triangles, Uint16Array);
    m.bnd = decode(m.boundary, Uint16Array);
    m.pot = decode(m.potential, Float32Array);
    m.pow = m.power ? decode(m.power, Float32Array) : null;
  }
  for (const m of L.disconnected){
    m.v = dequant(decode(m.vq, Uint16Array), m.bbox);
    m.t = decode(m.triangles, Uint16Array);
    m.bnd = decode(m.boundary, Uint16Array);
  }
  L.pts = decode(L.points, Float32Array);
}
// PLASMA / INFERNO approximations
function plasma(t){t=Math.min(1,Math.max(0,t));return [
  0.06+0.93*Math.pow(t,0.6)+0.1*Math.sin(3*t),
  0.02+0.02*t+0.95*Math.pow(t,2.2),
  0.53+1.2*t-2.9*t*t+1.5*t*t*t+0.2];}
function inferno(t){t=Math.min(1,Math.max(0,t));return [
  Math.pow(t,0.7)*1.1, Math.pow(t,1.8)*1.05, 0.15+2.2*t-6.4*t*t+4.6*t*t*t+0.35*t];}
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const vs = `attribute vec2 p; attribute vec3 col; uniform vec4 view; varying vec3 c;
 void main(){ vec2 q=(p-view.xy)*view.zw; gl_Position=vec4(q.x*2.0-1.0, 1.0-q.y*2.0,0.,1.);
  gl_PointSize=7.0; c=col; }`;
const fs = `precision mediump float; varying vec3 c; void main(){ gl_FragColor=vec4(c,1.); }`;
function shader(type, src){ const s=gl.createShader(type); gl.shaderSource(s,src);
 gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog,'p'), locC = gl.getAttribLocation(prog,'col');
const locView = gl.getUniformLocation(prog,'view');
let layerIdx=0, modeIdx=0, view={x:0,y:0,sx:1,sy:1};
let bbox=null, buffers=null, range=[0,1], rangeOverride=null, showEdges=false;
let showBoundary=false, showPoints=true, lastProbe=null;
// SI-prefixed value formatting/parsing (parity with padne_tpu.units:
// smart precision, prefix ladder p..T, 'u' accepted for micro).
const SI_EXP = {'12':'T','9':'G','6':'M','3':'k','0':'',
                '-3':'m','-6':'μ','-9':'n','-12':'p'};
const SI_MULT = {'T':1e12,'G':1e9,'M':1e6,'k':1e3,'m':1e-3,
                 'u':1e-6,'μ':1e-6,'n':1e-9,'p':1e-12};
function fmtSI(v, unit){
  if (v===0 || Math.abs(v)<1e-10) return '0 '+unit;
  let mag=Math.abs(v), exp=0;
  if (mag>=1){ while(mag>=1000 && exp<12){ mag/=1000; exp+=3; } }
  else { while(mag<1 && exp>-12){ mag*=1000; exp-=3; } }
  let text = mag>=100 ? mag.toFixed(1) : (mag>=10 ? mag.toFixed(2)
                                                  : mag.toFixed(3));
  if (text.indexOf('.')>=0){
    let e=text.length;
    while(text.charAt(e-1)==='0') e--;
    if (text.charAt(e-1)==='.') e--;
    text=text.slice(0,e);
  }
  return (v<0?'-':'')+text+' '+SI_EXP[String(exp)]+unit;
}
function parseSI(s, unit){
  if (!s) return NaN;
  let t=''; // strip all whitespace
  for (let i=0;i<s.length;i++) if (s.charAt(i)!==' ') t+=s.charAt(i);
  if (unit && t.endsWith(unit)) t=t.slice(0, t.length-unit.length);
  let mult=1;
  const last=t.charAt(t.length-1);
  if (SI_MULT[last]!==undefined){ mult=SI_MULT[last]; t=t.slice(0,-1); }
  // digits/sign/dot/exponent only beyond this point
  for (let i=0;i<t.length;i++){
    if ('0123456789+-.eE'.indexOf(t.charAt(i))<0) return NaN;
  }
  const num=parseFloat(t);
  return isFinite(num) ? num*mult : NaN;
}
function modeUnit(){ return modeIdx===0 ? 'V' : 'W/mm²'; }
function computeBBox(){
  let x0=1e30,y0=1e30,x1=-1e30,y1=-1e30;
  const L=DATA.layers[layerIdx];
  for (const group of [L.meshes, L.disconnected]) for (const m of group)
    for(let i=0;i<m.nv;i++){ const x=m.v[2*i], y=m.v[2*i+1];
      x0=Math.min(x0,x); y0=Math.min(y0,y); x1=Math.max(x1,x); y1=Math.max(y1,y); }
  bbox=[x0,y0,x1,y1];
}
function resetView(){
  computeBBox();
  const w=canvas.width, h=canvas.height;
  const dx=bbox[2]-bbox[0], dy=bbox[3]-bbox[1];
  const s=Math.min(w/(dx*1.1), h/(dy*1.1));
  view.sx=s/w; view.sy=s/h;
  view.x=(bbox[0]+bbox[2])/2 - w/(2*s);
  view.y=(bbox[1]+bbox[3])/2 - h/(2*s);
  draw();
}
function buildBuffers(){
  const L=DATA.layers[layerIdx];
  // Streaming min/max: spread (Math.min(...vals)) overflows the JS
  // argument stack beyond ~100k values — 1M-vertex boards need a loop.
  let lo=Infinity, hi=-Infinity;
  for (const m of L.meshes){
    const src = modeIdx===0 ? m.pot : m.pow;
    if (src) for (let i=0;i<src.length;i++){
      const v=src[i]; if(v<lo)lo=v; if(v>hi)hi=v; }
  }
  if (!(hi>lo)) hi=lo+1e-12;
  if (rangeOverride){ lo=rangeOverride[0]; hi=rangeOverride[1]; }
  range=[lo,hi];
  const cm = modeIdx===0 ? plasma : inferno;
  const tris=[]; const cols=[];
  for (const m of L.meshes){
    for(let t=0;t<m.nt;t++){
      for(let k=0;k<3;k++){
        const vi=m.t[3*t+k];
        tris.push(m.v[2*vi], m.v[2*vi+1]);
        let val = modeIdx===0 ? m.pot[vi] : (m.pow? m.pow[t] : 0);
        const c=cm((val-lo)/(hi-lo));
        cols.push(c[0],c[1],c[2]);
      }
    }
  }
  for (const m of L.disconnected){
    for(let t=0;t<m.nt;t++) for(let k=0;k<3;k++){
      const vi=m.t[3*t+k];
      tris.push(m.v[2*vi], m.v[2*vi+1]); cols.push(0.35,0.35,0.38);
    }
  }
  // Wireframe overlay: each triangle's three edges.
  const epos=[]; const ecol=[];
  if (showEdges){
    for (const m of L.meshes){
      for(let t=0;t<m.nt;t++){
        for(let k=0;k<3;k++){
          const a=m.t[3*t+k], b=m.t[3*t+(k+1)%3];
          epos.push(m.v[2*a], m.v[2*a+1], m.v[2*b], m.v[2*b+1]);
          ecol.push(0.1,0.1,0.12, 0.1,0.1,0.12);
        }
      }
    }
  }
  // Copper outlines (boundary edges) + connection-point markers — the
  // reference GUI's per-mesh boundary VAO and RenderedPoints.
  const bpos=[]; const bcol=[];
  if (showBoundary){
    for (const group of [L.meshes, L.disconnected]) for (const m of group){
      for(let i=0;i<m.bnd.length;i+=2){
        const a=m.bnd[i], b=m.bnd[i+1];
        bpos.push(m.v[2*a], m.v[2*a+1], m.v[2*b], m.v[2*b+1]);
        bcol.push(0.95,0.62,0.12, 0.95,0.62,0.12);
      }
    }
  }
  const ppos=[]; const pcol=[];
  if (showPoints){
    for(let i=0;i<L.npts;i++){
      ppos.push(L.pts[3*i], L.pts[3*i+1]);
      if (L.pts[3*i+2] > 0.5) pcol.push(0.92,0.26,0.21);  // sourced
      else pcol.push(0.72,0.72,0.75);                     // passive
    }
  }
  buffers = { n: tris.length/2, ne: epos.length/2,
    nb: bpos.length/2, np: ppos.length/2,
    pos: gl.createBuffer(), col: gl.createBuffer(),
    epos: gl.createBuffer(), ecol: gl.createBuffer(),
    bpos: gl.createBuffer(), bcol: gl.createBuffer(),
    ppos: gl.createBuffer(), pcol: gl.createBuffer() };
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.pos);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(tris), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.col);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(cols), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.epos);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(epos), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.ecol);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(ecol), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.bpos);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(bpos), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.bcol);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(bcol), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.ppos);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(ppos), gl.STATIC_DRAW);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.pcol);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(pcol), gl.STATIC_DRAW);
  drawLegend();
}
function drawLegend(){
  const g=document.getElementById('grad').getContext('2d');
  const cm = modeIdx===0 ? plasma : inferno;
  for(let i=0;i<220;i++){ const c=cm(i/219);
    g.fillStyle=`rgb(${255*c[0]|0},${255*c[1]|0},${255*c[2]|0})`;
    g.fillRect(i,0,1,12); }
  const unit = modeUnit();
  document.getElementById('vmin').textContent=fmtSI(range[0], unit);
  document.getElementById('vmax').textContent=fmtSI(range[1], unit);
  document.getElementById('vdelta').textContent=
    'Δ '+fmtSI(range[1]-range[0], unit);
}
function draw(){
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.08,0.08,0.1,1); gl.clear(gl.COLOR_BUFFER_BIT);
  if(!buffers) return;
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.pos);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,2,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER, buffers.col);
  gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  gl.uniform4f(locView, view.x, view.y, view.sx, view.sy);
  gl.drawArrays(gl.TRIANGLES, 0, buffers.n);
  if (showEdges && buffers.ne){
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.epos);
    gl.vertexAttribPointer(locP,2,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.ecol);
    gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.LINES, 0, buffers.ne);
  }
  if (showBoundary && buffers.nb){
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.bpos);
    gl.vertexAttribPointer(locP,2,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.bcol);
    gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.LINES, 0, buffers.nb);
  }
  if (showPoints && buffers.np){
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.ppos);
    gl.vertexAttribPointer(locP,2,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER, buffers.pcol);
    gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.POINTS, 0, buffers.np);
  }
}
function resize(){
  canvas.width=canvas.clientWidth; canvas.height=canvas.clientHeight; draw();
}
window.addEventListener('resize', resize);
// pan/zoom
let drag=null;
canvas.addEventListener('mousedown', e=>{ drag=[e.clientX,e.clientY]; });
window.addEventListener('mouseup', ()=>{ drag=null; });
canvas.addEventListener('mousemove', e=>{
  if(drag){
    view.x -= (e.clientX-drag[0])/(view.sx*canvas.width);
    view.y -= (e.clientY-drag[1])/(view.sy*canvas.height);
    drag=[e.clientX,e.clientY]; draw();
  } else probe(e);
});
canvas.addEventListener('wheel', e=>{
  e.preventDefault();
  const f = e.deltaY<0 ? 1.2 : 1/1.2;
  const mx = view.x + e.offsetX/(view.sx*canvas.width);
  const my = view.y + e.offsetY/(view.sy*canvas.height);
  view.sx*=f; view.sy*=f;
  view.x = mx - e.offsetX/(view.sx*canvas.width);
  view.y = my - e.offsetY/(view.sy*canvas.height);
  draw();
}, {passive:false});
function triContains(m, t, wx, wy){
  // Sign test against each edge (meshes are CCW; allow tiny negativity
  // for points on shared edges).
  const a=m.t[3*t], b=m.t[3*t+1], c=m.t[3*t+2];
  const ax=m.v[2*a], ay=m.v[2*a+1], bx=m.v[2*b], by=m.v[2*b+1],
        cx=m.v[2*c], cy=m.v[2*c+1];
  const eps=-1e-9*(Math.abs(bx-ax)+Math.abs(cy-ay)+1e-30);
  return ((bx-ax)*(wy-ay)-(by-ay)*(wx-ax)) >= eps
      && ((cx-bx)*(wy-by)-(cy-by)*(wx-bx)) >= eps
      && ((ax-cx)*(wy-cy)-(ay-cy)*(wx-cx)) >= eps;
}
function probeAt(wx, wy){
  // Returns {v, p} — nearest-vertex potential plus, when the point
  // falls inside a face, that face's power density (the
  // FaceSpatialIndex-style containing-triangle probe).
  const L=DATA.layers[layerIdx];
  let best=1e30, v=null, p=null;
  for (const m of L.meshes){
    for(let i=0;i<m.nv;i++){
      const dx=m.v[2*i]-wx, dy=m.v[2*i+1]-wy, d=dx*dx+dy*dy;
      if(d<best){ best=d; v=m.pot[i]; }
    }
    if (m.pow && p===null){
      for(let t=0;t<m.nt;t++)
        if (triContains(m, t, wx, wy)){ p=m.pow[t]; break; }
    }
  }
  return {v:v, p:p};
}
function probe(e){
  const wx = view.x + e.offsetX/(view.sx*canvas.width);
  const wy = view.y + e.offsetY/(view.sy*canvas.height);
  const r = probeAt(wx, wy);
  lastProbe = r;
  let txt='';
  if (r.v!==null){
    txt = `(${wx.toFixed(3)}, ${wy.toFixed(3)}) → ${r.v.toPrecision(6)} V`;
    if (r.p!==null) txt += ` | ${r.p.toPrecision(6)} W/mm²`;
  }
  document.getElementById('probe').textContent = txt;
}
// UI wiring
const sel=document.getElementById('layer');
DATA.layers.forEach((L,i)=>{ const o=document.createElement('option');
  o.textContent=L.name; o.value=i; sel.appendChild(o); });
sel.addEventListener('change', ()=>{ layerIdx=+sel.value; buildBuffers(); resetView(); });
document.getElementById('mode').addEventListener('change', e=>{
  modeIdx=e.target.selectedIndex; rangeOverride=null; buildBuffers(); draw(); });
document.getElementById('reset').addEventListener('click', resetView);
document.getElementById('edges').addEventListener('change', e=>{
  showEdges = e.target.checked; buildBuffers(); draw(); });
document.getElementById('boundary').addEventListener('change', e=>{
  showBoundary = e.target.checked; buildBuffers(); draw(); });
document.getElementById('points').addEventListener('change', e=>{
  showPoints = e.target.checked; buildBuffers(); draw(); });
// Keyboard tools (reference shortcuts: M / Shift+M set the color-scale
// min / max from the value under the cursor, C toggles connection
// points; B and E toggle the boundary / wireframe overlays).
window.addEventListener('keydown', e=>{
  if (e.key==='c' || e.key==='C'){
    showPoints = !showPoints;
    document.getElementById('points').checked = showPoints;
    buildBuffers(); draw();
  } else if (e.key==='b' || e.key==='B'){
    showBoundary = !showBoundary;
    document.getElementById('boundary').checked = showBoundary;
    buildBuffers(); draw();
  } else if (e.key==='e' || e.key==='E'){
    showEdges = !showEdges;
    document.getElementById('edges').checked = showEdges;
    buildBuffers(); draw();
  } else if ((e.key==='m' || e.key==='M') && lastProbe){
    const val = modeIdx===0 ? lastProbe.v : lastProbe.p;
    if (val!==null){
      rangeOverride = (e.key==='m') ? [val, range[1]] : [range[0], val];
      const box = (e.key==='m') ? 'vmin_in' : 'vmax_in';
      document.getElementById(box).value = fmtSI(val, modeUnit());
      buildBuffers(); draw();
    }
  }
});
document.getElementById('rescale').addEventListener('click', ()=>{
  const lo = parseSI(document.getElementById('vmin_in').value, modeUnit());
  const hi = parseSI(document.getElementById('vmax_in').value, modeUnit());
  rangeOverride = (isFinite(lo) && isFinite(hi) && hi > lo) ? [lo, hi] : null;
  buildBuffers(); draw(); });
resize(); buildBuffers(); resetView();
</script></body></html>
"""


def export_html(sol: solver_mod.Solution, output_file) -> None:
    payload = _solution_payload(sol)
    html = (
        _TEMPLATE
        .replace("__TITLE__", payload["project"])
        .replace("__RESID__", f"{payload['residual']:.2e}")
        .replace("__DATA__", json.dumps(payload))
    )
    Path(output_file).write_text(html)
