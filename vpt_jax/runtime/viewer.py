"""Interactive browser viewer: progressive rendering over HTTP.

The analog of the reference's application shell (Application.js +
MainDialog + canvas): the render loop runs server-side on the accelerator,
and a minimal single-page client orbits the camera with pointer drags, picks
renderer/tone mapper, and streams progressively refined frames.  Camera
motion resets accumulation exactly like the reference's Transform change
events (RenderingContext.js:42-46).

The transfer-function editor reproduces the reference's hallmark widget
(``src/js/ui/TransferFunction/TransferFunction.js``): Gaussian bumps dragged
on a 2D canvas (x = volume value, y = second TF axis), rasterized with the
same ``color·exp(-r²)`` additive blend server-side (transfer.rasterize), and
(de)serialized in the widget's JSON format.  A volume-value histogram is
drawn behind the bumps to guide placement.

Endpoints:
  GET /                 — the viewer page
  GET /frame?yaw=&pitch=&distance=&spp=&renderer=&tonemap=&extinction=
                        — advance the progressive render, return PNG
  GET /info             — renderer/tone-mapper lists + current state
  GET /tf               — current TF bumps (widget JSON list)
  POST /tf              — replace TF bumps (widget JSON list body)
  GET /tf.png           — rasterized TF texture preview
  GET /histogram        — volume value histogram (TF editor backdrop)
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>vpt_jax viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px sans-serif;
       display:flex; height:100vh; }
#view { flex:1; display:flex; align-items:center; justify-content:center; }
img { image-rendering:pixelated; cursor:grab; }
#panel { width:220px; padding:12px; background:#1a1a1a; }
select,input { width:100%; margin:2px 0 10px; background:#222; color:#ddd;
               border:1px solid #444; padding:4px; }
#stats { color:#888; margin-top:10px; white-space:pre; }
</style></head><body>
<div id="view"><img id="canvas" width="512" height="512"></div>
<div id="panel">
  <label>Renderer</label><select id="renderer"></select>
  <div id="rcost" style="color:#886; margin:-6px 0 8px"></div>
  <div id="rparams"></div>
  <label>Tone mapper</label><select id="tonemap"></select>
  <div id="tmparams"></div>
  <label>Samples / request</label>
  <div style="display:flex; gap:6px; align-items:center">
    <input id="spp" type="number" value="4" style="flex:1; margin:2px 0">
    <label style="white-space:nowrap; color:#888">
      <input id="autospp" type="checkbox" checked style="width:auto"> auto
    </label>
  </div>
  <label>Resolution</label>
  <select id="resolution">
    <option>128</option><option>256</option><option selected>512</option>
    <option>1024</option>
  </select>
  <label>Volume filter</label>
  <select id="filter"><option selected>linear</option><option>nearest</option>
  </select>
  <label>Volume translate</label>
  <input id="vtrans" value="0,0,0">
  <label>Volume rotate (deg)</label>
  <input id="vrot" value="0,0,0">
  <label>Volume scale</label>
  <input id="vscale" value="1,1,1">
  <label>Transfer function</label>
  <canvas id="tfedit" width="196" height="110"
          style="border:1px solid #444; background:#000; touch-action:none">
  </canvas>
  <div style="display:flex; gap:4px; margin:4px 0 0">
    <input id="tfcolor" type="color" value="#ff0000" style="flex:1; padding:0">
    <input id="tfalpha" type="range" min="0" max="1" step="0.01" value="1"
           style="flex:2">
  </div>
  <div style="display:flex; gap:4px; margin:4px 0 10px">
    <button id="tfadd">add</button><button id="tfdel">del</button>
    <button id="tfsave">save</button>
    <button id="tfload">load</button>
    <input id="tffile" type="file" accept=".json" style="display:none">
  </div>
  <div style="color:#666">drag bump · wheel resizes · dblclick adds<br>
  image: drag orbits · shift/right-drag pans · wheel zooms<br>
  keys: WASD fly · R/F lift · Q/E roll</div>
  <div id="stats"></div>
</div>
<script>
let yaw = 0.5, pitch = 0.3, roll = 0.0, distance = 2.0, focus = [0, 0, 0],
    dragging = 0, px = 0, py = 0, epoch = 0, busy = false, frames = 0;
let schema = {renderers: {}, tonemappers: {}}, rpVals = {}, tpVals = {};
const img = document.getElementById('canvas');
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('pointerdown', e => {
  dragging = (e.button === 2 || e.shiftKey) ? 2 : 1;
  px = e.clientX; py = e.clientY;
  img.setPointerCapture(e.pointerId); });
img.addEventListener('pointerup', () => dragging = 0);
img.addEventListener('pointermove', e => {
  if (!dragging) return;
  const dx = e.clientX - px, dy = e.clientY - py;
  if (dragging === 2) {
    // pan: translate focus in the camera plane (animators.pan)
    const cy = Math.cos(yaw), sy = Math.sin(yaw),
          cp = Math.cos(pitch), sp = Math.sin(pitch),
          back = [sy * cp, sp, cy * cp], right = [cy, 0, -sy],
          up = [back[1] * right[2] - back[2] * right[1],
                back[2] * right[0] - back[0] * right[2],
                back[0] * right[1] - back[1] * right[0]],
          k = 0.002 * distance;
    for (let i = 0; i < 3; i++)
      focus[i] += (-dx * right[i] + dy * up[i]) * k;
  } else {
    yaw -= dx * 0.01; pitch += dy * 0.01;
    pitch = Math.max(-1.5, Math.min(1.5, pitch));
  }
  px = e.clientX; py = e.clientY; epoch++; frames = 0; });
img.addEventListener('wheel', e => {
  e.preventDefault();
  distance *= Math.exp(e.deltaY * 0.001); epoch++; frames = 0; });
for (const id of ['renderer', 'tonemap', 'resolution',
                  'filter', 'vtrans', 'vrot', 'vscale'])
  document.getElementById(id).addEventListener('change',
    () => { epoch++; frames = 0; });
// ---- auto-generated settings panels (DialogConstructor parity) ----
function buildPanel(divId, fields, vals) {
  const div = document.getElementById(divId);
  div.innerHTML = '';
  for (const f of fields) {
    const label = document.createElement('label');
    label.textContent = f.name.replace(/_/g, ' ');
    div.appendChild(label);
    const inp = document.createElement('input');
    if (f.kind === 'bool') {
      inp.type = 'checkbox'; inp.checked = !!f.default;
      inp.style.width = 'auto';
      inp.addEventListener('change',
        () => { vals[f.name] = inp.checked; epoch++; frames = 0; });
    } else if (f.kind === 'vec') {
      inp.value = f.default.join(',');
      inp.addEventListener('change',
        () => { vals[f.name] = inp.value; epoch++; frames = 0; });
    } else {
      inp.type = 'number';
      if (f.kind === 'float') inp.step = 'any';
      inp.value = f.default;
      inp.addEventListener('change', () => {
        vals[f.name] = parseFloat(inp.value); epoch++; frames = 0; });
    }
    div.appendChild(inp);
  }
}
function rebuildPanels() {
  rpVals = {}; tpVals = {};
  buildPanel('rparams',
             schema.renderers[document.getElementById('renderer').value]
             || [], rpVals);
  buildPanel('tmparams',
             schema.tonemappers[document.getElementById('tonemap').value]
             || [], tpVals);
}
document.getElementById('renderer')
  .addEventListener('change', rebuildPanels);
document.getElementById('tonemap')
  .addEventListener('change', rebuildPanels);
// ---- WASD fly + R/F lift + Q/E roll (OrbitCameraAnimator.js:130-160) ----
window.addEventListener('keydown', e => {
  const tag = e.target.tagName;
  if (tag === 'INPUT' || tag === 'SELECT' || tag === 'TEXTAREA') return;
  const k = e.key.toLowerCase();
  if (k === 'q' || k === 'e') {
    roll += (k === 'q' ? -1 : 1) * 0.05;
    epoch++; frames = 0; return;
  }
  let f = 0, st = 0, l = 0;
  if (k === 'w') f = 1; else if (k === 's') f = -1;
  else if (k === 'a') st = -1; else if (k === 'd') st = 1;
  else if (k === 'r') l = 1; else if (k === 'f') l = -1;
  else return;
  const cy = Math.cos(yaw), sy = Math.sin(yaw),
        cp = Math.cos(pitch), sp = Math.sin(pitch),
        back = [sy * cp, sp, cy * cp], right = [cy, 0, -sy],
        up = [back[1] * right[2] - back[2] * right[1],
              back[2] * right[0] - back[0] * right[2],
              back[0] * right[1] - back[1] * right[0]],
        step = 0.05 * distance;
  for (let i = 0; i < 3; i++)
    focus[i] += (st * right[i] + l * up[i] - f * back[i]) * step;
  epoch++; frames = 0;
});
document.getElementById('resolution').addEventListener('change', e => {
  img.width = img.height = parseInt(e.target.value); });

// ---- transfer-function editor (widget parity) ----
const tfc = document.getElementById('tfedit'), tctx = tfc.getContext('2d');
let bumps = [], selected = -1, tfImg = new Image(), hist = [],
    tfTimer = null, tfDragging = false;
const toPx = b => [b.position.x * tfc.width, (1 - b.position.y) * tfc.height];

function drawTF() {
  tctx.clearRect(0, 0, tfc.width, tfc.height);
  if (tfImg.complete && tfImg.naturalWidth)
    tctx.drawImage(tfImg, 0, 0, tfc.width, tfc.height);
  tctx.strokeStyle = '#555'; tctx.beginPath();
  hist.forEach((v, i) => {
    const x = (i + 0.5) / hist.length * tfc.width,
          y = tfc.height * (1 - v * 0.9);
    i ? tctx.lineTo(x, y) : tctx.moveTo(x, y);
  });
  tctx.stroke();
  bumps.forEach((b, i) => {
    const [x, y] = toPx(b);
    tctx.beginPath(); tctx.arc(x, y, 6, 0, 7);
    tctx.strokeStyle = i === selected ? '#fff' : '#888';
    tctx.lineWidth = i === selected ? 2 : 1;
    tctx.stroke();
  });
}
function pushTF() {
  clearTimeout(tfTimer);
  tfTimer = setTimeout(async () => {
    await fetch('tf', {method: 'POST', body: JSON.stringify(bumps)});
    tfImg = new Image();
    tfImg.onload = drawTF;
    tfImg.src = 'tf.png?' + Date.now();
    epoch++; frames = 0;
  }, 150);
  drawTF();
}
function pickBump(e) {
  const r = tfc.getBoundingClientRect(),
        mx = e.clientX - r.left, my = e.clientY - r.top;
  let best = -1, bd = 144;
  bumps.forEach((b, i) => {
    const [x, y] = toPx(b), d = (x - mx) ** 2 + (y - my) ** 2;
    if (d < bd) { bd = d; best = i; }
  });
  return [best, mx / tfc.width, 1 - my / tfc.height];
}
function syncSelected() {
  if (selected < 0) return;
  const c = bumps[selected].color,
        hx = v => Math.round(v * 255).toString(16).padStart(2, '0');
  document.getElementById('tfcolor').value = '#' + hx(c.r) + hx(c.g) + hx(c.b);
  document.getElementById('tfalpha').value = c.a;
}
tfc.addEventListener('pointerdown', e => {
  const [i] = pickBump(e);
  selected = i; syncSelected();
  if (i >= 0) { tfDragging = true; tfc.setPointerCapture(e.pointerId); }
  drawTF();
});
tfc.addEventListener('pointermove', e => {
  if (!tfDragging || selected < 0) return;
  const [, u, v] = pickBump(e);
  bumps[selected].position = {x: Math.min(1, Math.max(0, u)),
                              y: Math.min(1, Math.max(0, v))};
  pushTF();
});
tfc.addEventListener('pointerup', () => tfDragging = false);
tfc.addEventListener('dblclick', e => {
  const [, u, v] = pickBump(e);
  bumps.push({position: {x: u, y: v}, size: {x: 0.2, y: 0.2},
              color: {r: 1, g: 0, b: 0, a: 1}});
  selected = bumps.length - 1; syncSelected(); pushTF();
});
tfc.addEventListener('wheel', e => {
  e.preventDefault();
  if (selected < 0) return;
  const s = Math.exp(-e.deltaY * 0.001), b = bumps[selected];
  b.size = {x: b.size.x * s, y: b.size.y * s};
  pushTF();
});
document.getElementById('tfadd').onclick = () => {
  bumps.push({position: {x: 0.5, y: 0.5}, size: {x: 0.2, y: 0.2},
              color: {r: 1, g: 0, b: 0, a: 1}});
  selected = bumps.length - 1; syncSelected(); pushTF();
};
document.getElementById('tfdel').onclick = () => {
  if (selected >= 0) { bumps.splice(selected, 1); selected = -1; pushTF(); }
};
document.getElementById('tfsave').onclick = () => {
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([JSON.stringify(bumps)],
                                        {type: 'application/json'}));
  a.download = 'transfer-function.json'; a.click();
};
document.getElementById('tfload').onclick =
  () => document.getElementById('tffile').click();
document.getElementById('tffile').addEventListener('change', async e => {
  if (e.target.files[0]) {
    bumps = JSON.parse(await e.target.files[0].text());
    selected = -1; pushTF();
  }
});
for (const id of ['tfcolor', 'tfalpha'])
  document.getElementById(id).addEventListener('input', () => {
    if (selected < 0) return;
    const hex = document.getElementById('tfcolor').value;
    bumps[selected].color = {
      r: parseInt(hex.slice(1, 3), 16) / 255,
      g: parseInt(hex.slice(3, 5), 16) / 255,
      b: parseInt(hex.slice(5, 7), 16) / 255,
      a: parseFloat(document.getElementById('tfalpha').value)};
    pushTF();
  });

function showCost() {
  // interactivity honesty: measured ms/frame at 512^2 defaults (served
  // by /info from renderers/factory.py) — warn before the
  // user picks a renderer that is seconds per progressive sample
  const costs = (window.frameCosts || {});
  const key = document.getElementById('renderer').value;
  const el = document.getElementById('rcost');
  const ms = costs[key];
  if (!ms) { el.textContent = ''; return; }
  el.textContent = ms >= 1000 ? `~${(ms / 1000).toFixed(1)} s/frame @512²`
                              : `~${ms} ms/frame @512²`;
  el.style.color = ms > 100 ? '#b84' : '#686';
}
async function init() {
  const info = await (await fetch('info')).json();
  for (const [id, list, def] of [["renderer", info.renderers, info.renderer],
                                 ["tonemap", info.tonemappers, info.tonemap]]) {
    const sel = document.getElementById(id);
    for (const name of list) {
      const o = document.createElement('option');
      o.value = o.textContent = name;
      if (name === def) o.selected = true;
      sel.appendChild(o);
    }
  }
  window.frameCosts = info.frame_cost_ms_512 || {};
  showCost();
  document.getElementById('renderer').addEventListener('change', showCost);
  const rsel = document.getElementById('resolution');
  if (![...rsel.options].some(o => o.value == info.resolution)) {
    const o = document.createElement('option');
    o.value = o.textContent = info.resolution;
    rsel.appendChild(o);
  }
  rsel.value = info.resolution;
  img.width = img.height = info.resolution;
  schema = info.schema;
  rebuildPanels();
  bumps = await (await fetch('tf')).json();
  hist = await (await fetch('histogram')).json();
  tfImg.onload = drawTF;
  tfImg.src = 'tf.png?' + Date.now();
  drawTF();
  loop();
}
async function loop() {
  if (busy) return;
  busy = true;
  const myEpoch = epoch;
  const q = new URLSearchParams({
    yaw, pitch, roll, distance, focus: focus.join(','),
    renderer: document.getElementById('renderer').value,
    tonemap: document.getElementById('tonemap').value,
    rp: JSON.stringify(rpVals),
    tp: JSON.stringify(tpVals),
    resolution: document.getElementById('resolution').value,
    filter: document.getElementById('filter').value,
    vtrans: document.getElementById('vtrans').value,
    vrot: document.getElementById('vrot').value,
    vscale: document.getElementById('vscale').value,
    spp: document.getElementById('spp').value,
    reset: frames === 0 ? '1' : '0',
  });
  const t0 = performance.now();
  const blob = await (await fetch('frame?' + q)).blob();
  const dt = performance.now() - t0;
  if (myEpoch === epoch) {
    img.src = URL.createObjectURL(blob);
    frames += parseInt(document.getElementById('spp').value);
    document.getElementById('stats').textContent =
      `accumulated: ${frames} spp\\nlast request: ${dt.toFixed(0)} ms`;
    if (document.getElementById('autospp').checked) {
      // tune samples-per-request toward ~150 ms so interaction stays
      // responsive while idle convergence uses bigger batches
      const spp = parseInt(document.getElementById('spp').value),
            next = Math.max(1, Math.min(64,
              Math.round(spp * Math.min(4, 150 / Math.max(dt, 1)))));
      if (next !== spp) document.getElementById('spp').value = next;
    }
  }
  busy = false;
  setTimeout(loop, 1);
}
init();
</script></body></html>
"""


class ViewerServer:
    def __init__(self, context=None, port: int = 8000,
                 host: str = "127.0.0.1"):
        from .context import RenderingContext

        if context is None:
            from .. import transfer, volume

            context = RenderingContext(resolution=512)
            context.set_volume(volume.sphere_volume(64))
            context.set_transfer_function(
                transfer.gray_ramp(alpha_scale=1.0))
            context.choose_renderer("mcm")
            context.choose_tone_mapper("reinhard")
        self.ctx = context
        self.lock = threading.Lock()
        self.host, self.port = host, port
        self._pose = None
        self._config = None
        self._trs = None
        self._server = None
        self.bumps = None  # TransferFunctionBumps once the editor touches it

    # -- request handling --------------------------------------------------
    def _parse_params(self, renderer: str, q):
        """Renderer Params from the ``rp`` JSON query value, coerced per
        the dataclass schema; returns (params, static_signature)."""
        import dataclasses

        from ..renderers import factory

        module = factory.get_module(renderer)
        raw = {}
        if "rp" in q:
            try:
                raw = json.loads(q["rp"][0])
            except (ValueError, TypeError):
                raw = {}
            if not isinstance(raw, dict):
                raw = {}
        elif "extinction" in q:          # legacy single-knob clients
            raw = {"extinction": q["extinction"][0]}
        kwargs = {}
        static_sig = []
        for f in dataclasses.fields(module.Params):
            if f.default is dataclasses.MISSING:
                continue
            val = raw.get(f.name, f.default)
            try:
                if isinstance(f.default, bool):
                    val = val if isinstance(val, bool) \
                        else str(val).lower() in ("1", "true", "yes", "on")
                elif isinstance(f.default, int):
                    val = int(float(val))
                elif isinstance(f.default, tuple):
                    if isinstance(val, str):
                        val = tuple(float(x) for x in val.split(","))
                    else:
                        val = tuple(float(x) for x in val)
                else:
                    val = float(val)
            except (TypeError, ValueError):
                val = f.default
            kwargs[f.name] = val
            if f.metadata.get("static"):
                static_sig.append((f.name, val))
        return module.Params(**kwargs), tuple(static_sig)

    def _apply_query(self, q):
        ctx = self.ctx
        yaw = float(q.get("yaw", ["0"])[0])
        pitch = float(q.get("pitch", ["0"])[0])
        roll = float(q.get("roll", ["0"])[0])
        distance = float(q.get("distance", ["2"])[0])
        renderer = q.get("renderer", [ctx.renderer_key or "mcm"])[0]
        tonemap = q.get("tonemap", [ctx.tone_mapper.name])[0]
        resolution = int(q.get("resolution", [str(ctx.resolution)])[0])
        vol_filter = q.get("filter", [ctx.filter])[0]
        reset = q.get("reset", ["0"])[0] == "1"
        params, static_sig = self._parse_params(renderer, q)
        tm_params = {}
        if "tp" in q:
            try:
                tm_params = {k: float(v)
                             for k, v in json.loads(q["tp"][0]).items()}
            except (ValueError, TypeError, AttributeError):
                tm_params = {}

        def vec(name, default):
            try:
                parts = [float(x) for x in
                         q.get(name, [default])[0].split(",")]
                return tuple(parts) if len(parts) == 3 else None
            except ValueError:
                return None
        trs = (vec("vtrans", "0,0,0"), vec("vrot", "0,0,0"),
               vec("vscale", "1,1,1"))

        focus = vec("focus", "0,0,0") or (0.0, 0.0, 0.0)

        config = (renderer, resolution, vol_filter, static_sig)
        pose = (yaw, pitch, roll, distance, focus)
        if config != self._config or ctx.renderer is None:
            # renderer switch / static-param / resolution / filter change:
            # rebuild (recompile-class knobs, like the reference's shader
            # rebuilds)
            self._config = config
            if resolution != ctx.resolution:
                ctx.set_resolution(resolution)
            if vol_filter != ctx.filter:
                ctx.set_filter(vol_filter)
            ctx.choose_renderer(renderer, params=params)
        elif params != ctx.renderer.params:
            # traced-param change (GL-uniform class): swap the params and
            # reset accumulation WITHOUT recompiling — the jit signature is
            # unchanged (Application.js:130-138 reset-on-change semantics)
            ctx.renderer.params = params
            ctx.renderer.state = None
        if (tonemap != ctx.tone_mapper.name
                or tm_params != ctx.tone_mapper.params):
            # display-only: no accumulation reset, as in the reference
            ctx.choose_tone_mapper(tonemap, **tm_params)
        if pose != self._pose or reset:
            # camera-only change: move the camera (fires the accumulation
            # reset listener) but KEEP the compiled renderer
            self._pose = pose
            ctx.camera_animator.yaw = yaw
            ctx.camera_animator.pitch = pitch
            ctx.camera_animator.roll = roll
            ctx.camera_animator.distance = distance
            ctx.camera_animator.focus = np.asarray(focus, np.float32)
            ctx.camera_animator._update_camera()
        if trs != self._trs and all(trs):
            # volume TRS (RenderingContextDialog parity): matrices-only
            # refresh — the transform change listener resets accumulation
            self._trs = trs
            from .. import math3d as m4

            translate, rotate, scale = trs
            ctx.volume_transform.local_translation = translate
            ctx.volume_transform.local_rotation = m4.quat_from_euler(*rotate)
            ctx.volume_transform.local_scale = scale

    def _render_png(self, q) -> bytes:
        from ..io.image import encode_png, to_uint8

        with self.lock:
            self._apply_query(q)
            self.ctx.render(frames=int(q.get("spp", ["4"])[0]))
            arr = to_uint8(np.asarray(self.ctx.get_display_image()))
        return encode_png(arr)

    # -- transfer-function editor -----------------------------------------
    def _tf_list(self) -> bytes:
        return json.dumps(self.bumps.to_list()
                          if self.bumps is not None else []).encode()

    def _tf_set(self, body: bytes) -> bytes:
        from .. import transfer

        bumps = transfer.TransferFunctionBumps.from_list(json.loads(body))
        with self.lock:
            self.bumps = bumps
            self.ctx.set_transfer_function(transfer.rasterize(bumps))
        return b'{"ok": true}'

    def _tf_png(self) -> bytes:
        from ..io.image import encode_png

        with self.lock:
            tex = np.asarray(self.ctx.transfer_texture)
        return encode_png((np.clip(tex[::-1], 0.0, 1.0) * 255)
                          .astype(np.uint8))

    def _histogram(self, bins: int = 96) -> bytes:
        vol = getattr(self.ctx, "volume", None)
        if vol is None:
            return b"[]"
        counts, _ = np.histogram(np.asarray(vol.data[..., 0]).ravel(),
                                 bins=bins, range=(0.0, 1.0))
        # log scale reads better for mostly-empty volumes
        counts = np.log1p(counts.astype(np.float64))
        peak = counts.max() or 1.0
        return json.dumps([round(float(c / peak), 4)
                           for c in counts]).encode()

    @staticmethod
    def _param_schema() -> dict:
        """Parameter schemas for every renderer Params dataclass and every
        tone-mapper function — the same declarative walk that generates the
        CLI flags (cli._add_params_args), here feeding the auto-generated
        settings panels (DialogConstructor.js:5-35 parity)."""
        import dataclasses
        import inspect

        from ..renderers import factory
        from ..tonemap import TONE_MAPPERS

        def field_spec(name, default, static):
            if isinstance(default, bool):
                kind = "bool"
            elif isinstance(default, int):
                kind = "int"
            elif isinstance(default, tuple):
                kind = "vec"
                default = list(default)
            else:
                kind = "float"
            return {"name": name, "kind": kind, "default": default,
                    "static": static}

        renderers = {}
        for key in factory.MODULES:
            renderers[key] = [
                field_spec(f.name, f.default, bool(f.metadata.get("static")))
                for f in dataclasses.fields(factory.get_module(key).Params)
                if f.default is not dataclasses.MISSING]
        tonemappers = {}
        for name, fn in TONE_MAPPERS.items():
            tonemappers[name] = [
                field_spec(p.name, float(p.default), False)
                for p in inspect.signature(fn).parameters.values()
                if p.default is not inspect.Parameter.empty]
        return {"renderers": renderers, "tonemappers": tonemappers}

    def _info(self) -> bytes:
        from ..renderers import factory
        from ..tonemap import TONE_MAPPERS

        # tracking telemetry: which empty-space machine the policy actually
        # engaged for this scene, and how empty the scene measured
        tracking = {"mode": self.ctx.tracking, "engaged": "none"}
        try:
            scene = self.ctx.get_scene()
        except RuntimeError:
            scene = None
        if scene is not None and scene.tracking_packed is not None:
            from .. import skipgrid

            tracking = {"mode": self.ctx.tracking, "engaged": "cheb",
                        "empty_fraction": round(
                            skipgrid.empty_fraction(scene.tracking_packed),
                            4)}
        elif scene is not None and scene.majorant is not None:
            tracking = {"mode": self.ctx.tracking, "engaged": "grid"}

        return json.dumps({
            "renderers": sorted(factory.MODULES),
            "tonemappers": sorted(TONE_MAPPERS),
            "renderer": self.ctx.renderer_key or "mcm",
            "tonemap": self.ctx.tone_mapper.name,
            "resolution": self.ctx.resolution,
            "tracking": tracking,
            "frame_cost_ms_512": factory.FRAME_COST_MS_512,
            "schema": self._param_schema(),
        }).encode()

    # -- server ------------------------------------------------------------
    def make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(parsed.query)
                try:
                    if parsed.path in ("/", "/index.html"):
                        body, ctype = _PAGE.encode(), "text/html"
                    elif parsed.path == "/frame":
                        body, ctype = viewer._render_png(q), "image/png"
                    elif parsed.path == "/info":
                        body, ctype = viewer._info(), "application/json"
                    elif parsed.path == "/tf":
                        body, ctype = viewer._tf_list(), "application/json"
                    elif parsed.path == "/tf.png":
                        body, ctype = viewer._tf_png(), "image/png"
                    elif parsed.path == "/histogram":
                        body, ctype = viewer._histogram(), "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # surface render errors to client
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path != "/tf":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = viewer._tf_set(self.rfile.read(length))
                except Exception as e:
                    self.send_error(400, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def serve_forever(self):
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self.make_handler())
        print(f"vpt_jax viewer on http://{self.host}:"
              f"{self._server.server_address[1]}")
        self._server.serve_forever()

    def serve_background(self):
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self.make_handler())
        thread = threading.Thread(target=self._server.serve_forever,
                                  daemon=True)
        thread.start()
        return self._server.server_address[1]

    def shutdown(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
