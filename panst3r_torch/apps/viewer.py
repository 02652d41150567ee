"""Zero-dependency 3D scene viewer (counterpart of
panst3r_tpu/apps/viewer.py).

A single-file WebGL1 point-cloud renderer (orbit, pan and zoom, segment
labels at their medoids, camera frusta) served over the standard
library's ``http.server``.  It serves the directory that
``apps/demo.py::export_scene`` writes: ``scene.ply`` and
``cameras.json``.  It needs no card and imports neither torch nor the
model.

Run:  python -m panst3r_torch.apps.viewer --scene demo_out/ --port 8080
"""
from __future__ import annotations

import argparse
import functools
import http.server
from pathlib import Path

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>panst3r_torch viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px;
        border-radius:6px; z-index:2; }
 .seglabel { position:fixed; background:#000a; color:#fff; padding:1px 5px;
        border-radius:4px; font-size:11px; pointer-events:none; z-index:1; }
 canvas { display:block; }
</style></head><body>
<div id="hud">panst3r_torch — drag: orbit, shift-drag: pan, wheel: zoom<br>
<span id="info">loading…</span><br>
<label><input type="checkbox" id="spin"> auto-orbit</label>
<label><input type="checkbox" id="lbl" checked> labels</label></div>
<div id="labels"></div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const VS = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
 varying vec3 vc; void main(){ gl_Position = mvp*vec4(p,1.0);
 gl_PointSize = 2.0; vc = col; }`;
const FS = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc,1.0); }`;
function sh(type, src){ const s = gl.createShader(type);
 gl.shaderSource(s, src); gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);

let n = 0, theta = 0.6, phi = 1.2, radius = 6, cx=0, cy=0, cz=0;
function mat(){
  const aspect = canvas.width/canvas.height;
  const eye = [cx+radius*Math.sin(phi)*Math.cos(theta),
               cy+radius*Math.cos(phi),
               cz+radius*Math.sin(phi)*Math.sin(theta)];
  const f = 1.5, near=0.01, far=1000;
  // lookAt
  let zx=eye[0]-cx, zy=eye[1]-cy, zz=eye[2]-cz;
  let zl=Math.hypot(zx,zy,zz); zx/=zl; zy/=zl; zz/=zl;
  let xx=zy*0-zz*1, xy=zz*0-zx*0, xz=zx*1-zy*0; // up=(0,1,0) cross
  xx = 1*zz-0*zy; xy = 0*zx-0*zz; xz = 0*zy-1*zx; // up x z
  let xl=Math.hypot(xx,xy,xz)||1; xx/=xl; xy/=xl; xz/=xl;
  const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
  const tx=-(xx*eye[0]+xy*eye[1]+xz*eye[2]);
  const ty=-(yx*eye[0]+yy*eye[1]+yz*eye[2]);
  const tz=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
  const nf = 1/(near-far);
  // column-major proj*view
  const P = [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
             0,0,2*far*near*nf,0];
  const V = [xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, tx,ty,tz,1];
  const M = new Float32Array(16);
  for(let i=0;i<4;i++) for(let j=0;j<4;j++){
    M[i*4+j]=0; for(let k=0;k<4;k++) M[i*4+j]+=P[k*4+j]*V[i*4+k]; }
  return M;
}
let pb=null, cb=null, fb=null, fcb=null, nf=0, labels=[];
function bindAttr(buf, name){
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  const l = gl.getAttribLocation(prog, name);
  gl.enableVertexAttribArray(l);
  gl.vertexAttribPointer(l,3,gl.FLOAT,false,0,0);
}
function project(M, p){
  const x=M[0]*p[0]+M[4]*p[1]+M[8]*p[2]+M[12];
  const y=M[1]*p[0]+M[5]*p[1]+M[9]*p[2]+M[13];
  const w=M[3]*p[0]+M[7]*p[1]+M[11]*p[2]+M[15];
  return [x/w, y/w, w];
}
function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.07,0.07,0.07,1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const M = mat();
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,'mvp'), false, M);
  if(pb){ bindAttr(pb,'p'); bindAttr(cb,'col');
          gl.drawArrays(gl.POINTS, 0, n); }
  if(fb){ bindAttr(fb,'p'); bindAttr(fcb,'col');
          gl.drawArrays(gl.LINES, 0, nf); }
  // 3D segment labels at their medoids
  const box = document.getElementById('labels');
  const show = document.getElementById('lbl').checked;
  box.innerHTML = '';
  if(show) for(const L of labels){
    const s = project(M, L.pos);
    if(s[2] <= 0) continue;
    const el = document.createElement('div');
    el.className = 'seglabel'; el.textContent = L.name;
    el.style.left = ((s[0]*0.5+0.5)*canvas.width)+'px';
    el.style.top = ((-s[1]*0.5+0.5)*canvas.height)+'px';
    box.appendChild(el);
  }
}
setInterval(()=>{ if(document.getElementById('spin').checked){
  theta += 0.01; draw(); } }, 33);
let drag=false, panning=false, lx=0, ly=0;
canvas.onmousedown = e=>{drag=true; panning=e.shiftKey; lx=e.x; ly=e.y;};
onmouseup = ()=>drag=false;
onmousemove = e=>{ if(!drag) return;
  if(panning){ cx -= (e.x-lx)*0.003*radius; cy += (e.y-ly)*0.003*radius; }
  else { theta += (e.x-lx)*0.01; phi = Math.min(3.1, Math.max(0.05,
         phi - (e.y-ly)*0.01)); }
  lx=e.x; ly=e.y; draw(); };
onwheel = e=>{ radius *= Math.exp(e.deltaY*0.001); draw(); };
onresize = draw;

fetch('scene.ply').then(r=>r.text()).then(txt=>{
  const lines = txt.split('\\n');
  let i=0, count=0;
  for(; i<lines.length; i++){
    if(lines[i].startsWith('element vertex')) count=+lines[i].split(' ')[2];
    if(lines[i]==='end_header'){ i++; break; }
  }
  const pos = new Float32Array(count*3), col = new Float32Array(count*3);
  let sx=0, sy=0, sz=0;
  for(let k=0;k<count;k++){
    const t = lines[i+k].split(' ');
    pos[3*k]=+t[0]; pos[3*k+1]=-t[1]; pos[3*k+2]=-t[2];
    col[3*k]=t[3]/255; col[3*k+1]=t[4]/255; col[3*k+2]=t[5]/255;
    sx+=pos[3*k]; sy+=pos[3*k+1]; sz+=pos[3*k+2];
  }
  cx=sx/count; cy=sy/count; cz=sz/count; n=count;
  pb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
  cb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.bufferData(gl.ARRAY_BUFFER, col, gl.STATIC_DRAW);
  document.getElementById('info').textContent = count + ' points';
  draw();
});
const W2V = p => [p[0], -p[1], -p[2]];  // PLY→view flip (see loader)
fetch('cameras.json').then(r=>r.json()).then(m=>{
  const info = document.getElementById('info');
  info.textContent += ' · ' + m.segments_info.length + ' segments';
  labels = (m.labels||[]).map(L=>({name:L.name, pos:W2V(L.pos)}));
  // Camera frusta from cams2world and the focals.
  if(m.cams2world && m.image_size){
    const [H, W] = m.image_size, d = 0.25, verts = [];
    m.cams2world.forEach((T, i)=>{
      const f = m.focals[i];
      const corners = [[-W/2/f*d,-H/2/f*d,d],[W/2/f*d,-H/2/f*d,d],
                       [W/2/f*d,H/2/f*d,d],[-W/2/f*d,H/2/f*d,d]];
      const tf = p=>W2V([T[0][0]*p[0]+T[0][1]*p[1]+T[0][2]*p[2]+T[0][3],
                         T[1][0]*p[0]+T[1][1]*p[1]+T[1][2]*p[2]+T[1][3],
                         T[2][0]*p[0]+T[2][1]*p[1]+T[2][2]*p[2]+T[2][3]]);
      const o = tf([0,0,0]), c = corners.map(tf);
      for(let k=0;k<4;k++){ verts.push(...o, ...c[k]);
                            verts.push(...c[k], ...c[(k+1)%4]); }
    });
    nf = verts.length/3;
    fb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, fb);
    gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(verts), gl.STATIC_DRAW);
    const fc = new Float32Array(verts.length);
    for(let k=0;k<nf;k++){ fc[3*k]=1.0; fc[3*k+1]=0.6; fc[3*k+2]=0.1; }
    fcb = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, fcb);
    gl.bufferData(gl.ARRAY_BUFFER, fc, gl.STATIC_DRAW);
  }
  draw();
}).catch(()=>{});
</script></body></html>
"""


class _Handler(http.server.SimpleHTTPRequestHandler):
    """The page at ``/``, the scene directory's files elsewhere."""

    def __init__(self, *args, scene_dir: Path, **kw):
        self.scene_dir = scene_dir
        super().__init__(*args, directory=str(scene_dir), **kw)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = _HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            super().do_GET()

    def log_message(self, *a):
        pass


def make_server(scene_dir: str, host: str = "127.0.0.1", port: int = 8080):
    """A threading HTTP server for ``scene_dir`` (port 0: any free one;
    ``server_address`` has the port bound)."""
    handler = functools.partial(_Handler, scene_dir=Path(scene_dir))
    return http.server.ThreadingHTTPServer((host, port), handler)


def serve(scene_dir: str, host: str = "127.0.0.1", port: int = 8080):
    srv = make_server(scene_dir, host, port)
    print(f"viewer at http://{host}:{srv.server_address[1]}/  "
          f"(scene: {scene_dir})")
    srv.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True,
                    help="directory with scene.ply (+ cameras.json)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    serve(args.scene, args.host, args.port)


if __name__ == "__main__":
    main()
