"""Interactive 3D scene viewer as one self-contained HTML file (port of
dream2real_tpu/vis/viewer.py; given the same inputs, the file is the same
byte for byte).

The ``vis.gui`` config flag exports ``viewer.html`` into the artifact
directory in place of the reference's Open3D windows and NGP GUI: the
geometry is embedded as JSON and drawn by a dependency-free canvas orbit
viewer (drag = orbit, wheel = zoom, shift-drag = pan, layer checkboxes). It
needs no network and no three.js.

Geometry is subsampled to keep the file and the 2D-canvas painter loop
responsive: points are capped per layer, mesh triangles are drawn as depth-
sorted flat-shaded faces with a face cap.
"""

from __future__ import annotations

import json
import os

import numpy as np

MAX_POINTS = 60_000
MAX_FACES = 20_000


def _cap_points(pts, colors, cap=MAX_POINTS):
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    n = len(pts)
    idx = np.arange(n)
    if n > cap:
        idx = np.linspace(0, n - 1, cap).astype(np.int64)
        pts = pts[idx]
    if colors is None:
        cols = None
    else:
        cols = np.asarray(colors).reshape(-1, 3)[idx]
        if cols.dtype != np.uint8:
            cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    return pts, cols


def _cap_mesh(verts, faces, cap=MAX_FACES):
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if len(faces) > cap:
        sel = np.linspace(0, len(faces) - 1, cap).astype(np.int64)
        faces = faces[sel]
        used, inv = np.unique(faces.reshape(-1), return_inverse=True)
        verts = verts[used]
        faces = inv.reshape(-1, 3)
    return verts, faces


def export_scene_html(
    path: str,
    points=None,   # [(pts (N,3), colors (N,3) u8/float/None, name)]
    meshes=None,   # [(verts (V,3), faces (F,3), "#rrggbb", name)]
    frames=None,   # [(T (4,4) pose, name)] drawn as RGB axis triads
    title: str = "dream2real_tpu scene",
) -> str:
    layers = []
    for pts, cols, name in points or []:
        pts, cols = _cap_points(pts, cols)
        layers.append({
            "kind": "points", "name": name,
            "pts": np.round(pts, 4).tolist(),
            "cols": None if cols is None else cols.tolist(),
        })
    for verts, faces, color, name in meshes or []:
        verts, faces = _cap_mesh(verts, faces)
        layers.append({
            "kind": "mesh", "name": name, "color": color,
            "verts": np.round(verts, 4).tolist(),
            "faces": faces.tolist(),
        })
    for T, name in frames or []:
        layers.append({
            "kind": "frame", "name": name,
            "T": np.round(np.asarray(T, np.float64), 5).tolist(),
        })

    data = json.dumps({"title": title, "layers": layers})
    html = _TEMPLATE.replace("__TITLE__", title).replace("__DATA__", data)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #ui{position:fixed;top:8px;left:8px;background:#222a;padding:8px;border-radius:6px}
 #ui label{display:block;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="ui"><b>__TITLE__</b><div id="layers"></div>
<small>drag orbit &middot; wheel zoom &middot; shift-drag pan</small></div>
<canvas id="cv"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener('resize', resize);
// scene bounds -> centre/scale
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
function acc(p){for(let i=0;i<3;i++){if(p[i]<lo[i])lo[i]=p[i];if(p[i]>hi[i])hi[i]=p[i];}}
for(const L of DATA.layers){
  if(L.kind==='points') L.pts.forEach(acc);
  if(L.kind==='mesh') L.verts.forEach(acc);
  if(L.kind==='frame') acc([L.T[0][3],L.T[1][3],L.T[2][3]]);
}
const ctr=[0,1,2].map(i=>(lo[i]+hi[i])/2);
const ext=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-6);
let yaw=0.8, pitch=0.5, dist=2.2, panx=0, pany=0;
const vis={}; DATA.layers.forEach((L,i)=>vis[i]=true);
const ui=document.getElementById('layers');
DATA.layers.forEach((L,i)=>{
  const l=document.createElement('label');
  const c=document.createElement('input'); c.type='checkbox'; c.checked=true;
  c.onchange=()=>{vis[i]=c.checked;draw();};
  l.appendChild(c); l.appendChild(document.createTextNode(' '+L.name));
  ui.appendChild(l);
});
function proj(p){
  // world -> unit -> camera (orbit) -> screen
  const x=(p[0]-ctr[0])/ext, y=(p[1]-ctr[1])/ext, z=(p[2]-ctr[2])/ext;
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1=cy*x+sy*y, y1=-sy*x+cy*y;          // yaw about z
  const y2=cp*y1-sp*z, z2=sp*y1+cp*z;         // pitch
  const zc=dist-y2;                            // camera looks along +y2
  if(zc<=0.05) return null;
  const f=0.9*Math.min(W,H)/zc;
  return [W/2+f*x1+panx, H/2-f*z2+pany, zc];
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const tris=[];
  DATA.layers.forEach((L,i)=>{
    if(!vis[i]) return;
    if(L.kind==='points'){
      for(let j=0;j<L.pts.length;j++){
        const s=proj(L.pts[j]); if(!s) continue;
        ctx.fillStyle=L.cols?`rgb(${L.cols[j][0]},${L.cols[j][1]},${L.cols[j][2]})`:'#6cf';
        ctx.fillRect(s[0],s[1],2,2);
      }
    } else if(L.kind==='mesh'){
      const P=L.verts.map(proj);
      for(const f of L.faces){
        const a=P[f[0]],b=P[f[1]],c=P[f[2]];
        if(!a||!b||!c) continue;
        tris.push({z:(a[2]+b[2]+c[2])/3, a,b,c, col:L.color});
      }
    } else if(L.kind==='frame'){
      const T=L.T, o=[T[0][3],T[1][3],T[2][3]];
      const so=proj(o); if(!so) return;
      const axc=['#f55','#5f5','#59f'];
      for(let ax=0;ax<3;ax++){
        const e=[0,1,2].map(r=>o[r]+0.08*ext*T[r][ax]);
        const se=proj(e); if(!se) continue;
        ctx.strokeStyle=axc[ax]; ctx.beginPath();
        ctx.moveTo(so[0],so[1]); ctx.lineTo(se[0],se[1]); ctx.stroke();
      }
      ctx.fillStyle='#eee'; ctx.fillText(L.name, so[0]+4, so[1]-4);
    }
  });
  tris.sort((u,v)=>v.z-u.z);
  for(const t of tris){
    ctx.fillStyle=t.col+'cc'; ctx.strokeStyle='#0006';
    ctx.beginPath(); ctx.moveTo(t.a[0],t.a[1]); ctx.lineTo(t.b[0],t.b[1]);
    ctx.lineTo(t.c[0],t.c[1]); ctx.closePath(); ctx.fill(); ctx.stroke();
  }
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panx+=dx;pany+=dy;} else {yaw+=dx*0.008;pitch+=dy*0.008;
    pitch=Math.max(-1.55,Math.min(1.55,pitch));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();
});
cv.addEventListener('wheel',e=>{dist*=Math.pow(1.1,e.deltaY>0?1:-1);
  dist=Math.max(0.3,Math.min(20,dist)); draw(); e.preventDefault();});
resize();
</script></body></html>
"""
