"""Web demo on the port: upload images or paste URLs -> prediction cards
(counterpart of the repository's ``web/app.py``, which drives the JAX
package).

One route taking multipart ``files[]`` and newline-separated ``urls``,
answering with base64-JPEG result cards labeled ``<name>\\n<confidence%>``
and a daemon banner (Inactive / CPU / GPU); dual-stack servers on 20810
(IPv4) and 20811 (IPv6), or single-stack on port 80 with ``--debug``. The
model daemon is the port's (``web/runtime.py``), on ``--device`` (``cuda``
by default). Runs on the port's stdlib WSGI kit (``utils/httpkit.py``).

CLI: ``python -m touhouimageclassification_tpu_torch.web.app --device cuda``
"""
from __future__ import annotations

import base64
from io import BytesIO

from ..utils.httpkit import (Request, Response, escape, make_wsgi_app,
                             serve_dual_stack)
from . import runtime
from .runtime import (DEFAULT_LABEL_LANG, is_daemon_accelerated,
                      is_daemon_running, serve_batch)

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>TouhouIC demo</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 :root {{ --accent: #7c4dbe; --accent-soft: #ede5f7; --line: #d9d4e3; }}
 * {{ box-sizing: border-box; }}
 body {{ font-family: "Segoe UI", system-ui, sans-serif; margin: 0;
         background: linear-gradient(170deg, #faf8ff 0%, #f1edf8 100%);
         min-height: 100vh; color: #2b2733; }}
 .wrap {{ max-width: 980px; margin: 0 auto; padding: 2.2em 1.2em 3em; }}
 header {{ display: flex; align-items: baseline; gap: 1em;
           flex-wrap: wrap; margin-bottom: 1.1em; }}
 h1 {{ margin: 0; font-size: 1.7em; letter-spacing: .01em; }}
 .banner {{ padding: .3em .9em; border-radius: 999px; font-size: .85em;
            font-weight: 600; background: #e4e1ea; color: #5a5566; }}
 .banner.on {{ background: #ddf3e4; color: #196639; }}
 .panel {{ background: #fff; border: 1px solid var(--line);
           border-radius: 14px; padding: 1.3em;
           box-shadow: 0 4px 18px rgba(60, 40, 110, .06); }}
 .drop {{ border: 2px dashed var(--line); border-radius: 10px;
          padding: 2.2em 1em; text-align: center; color: #6d6879;
          cursor: pointer; transition: border-color .15s, background .15s; }}
 .drop.hover {{ border-color: var(--accent); background: var(--accent-soft); }}
 .drop strong {{ color: var(--accent); }}
 textarea {{ width: 100%; margin-top: .9em; border: 1px solid var(--line);
             border-radius: 8px; padding: .6em; font: inherit; resize: vertical; }}
 .actions {{ display: flex; align-items: center; gap: 1em; margin-top: 1em;
             flex-wrap: wrap; }}
 .langs {{ display: inline-flex; border: 1px solid var(--line);
           border-radius: 8px; overflow: hidden; }}
 .langs button {{ border: 0; background: #fff; padding: .45em .95em;
                  font: inherit; cursor: pointer; }}
 .langs button.active {{ background: var(--accent); color: #fff; }}
 .go {{ margin-left: auto; background: var(--accent); color: #fff; border: 0;
        border-radius: 8px; padding: .55em 1.6em; font: inherit;
        font-weight: 600; cursor: pointer; }}
 .go:hover {{ filter: brightness(1.08); }}
 .flash {{ color: #06529b; margin: .9em 0 0; }}
 .error {{ color: #b00020; margin: .9em 0 0; }}
 .hint {{ color: #6d6879; font-size: .88em; margin: .9em 0 0; }}
 #spin {{ display: none; margin: 1.2em auto 0; width: 34px; height: 34px;
          border: 4px solid var(--accent-soft); border-top-color: var(--accent);
          border-radius: 50%; animation: r 1s linear infinite; }}
 @keyframes r {{ to {{ transform: rotate(360deg); }} }}
 .cards {{ display: grid; gap: 14px; margin-top: 1.3em;
           grid-template-columns: repeat(auto-fill, minmax(190px, 1fr)); }}
 .card {{ background: #fff; border: 1px solid var(--line); border-radius: 12px;
          padding: 10px; text-align: center;
          box-shadow: 0 2px 10px rgba(60, 40, 110, .05); }}
 .card img {{ max-width: 100%; border-radius: 8px; }}
 .pred {{ white-space: pre-line; font-weight: 700; margin-top: .4em; }}
 .fname {{ color: #6d6879; font-size: .82em; overflow-wrap: anywhere; }}
 .intro {{ color: #4a4556; }}
</style></head><body><div class="wrap">
<header>
  <h1>Touhou character classifier</h1>
  <span class="banner{device_on}">Model daemon: {device_mode}</span>
</header>
<form class="panel" method="post" enctype="multipart/form-data"
      onsubmit="document.getElementById('spin').style.display='block'">
  <div class="drop" id="drop">
    <p id="drop-label"><strong>Drag &amp; drop</strong> images here, or click to select files</p>
    <input type="file" name="files[]" id="files" multiple accept="image/*" hidden>
  </div>
  <textarea name="urls" rows="3"
            placeholder="Or paste image URLs here, one per line"></textarea>
  <div class="actions">
    <span>Labels:</span>
    <span class="langs" id="langs">
      <button type="button" data-lang="EN" {en}>EN</button>
      <button type="button" data-lang="JP" {jp}>JP</button>
      <button type="button" data-lang="CN" {cn}>CN</button>
    </span>
    <input type="hidden" name="lang" id="lang" value="{lang}">
    <button type="submit" class="go">Classify</button>
  </div>
  <p class="hint">The first request can take a while: the model daemon loads
  on demand, then stays warm.</p>
  <div id="spin"></div>
</form>
{flashes}
{intro}
<div class="cards">{cards}</div>
</div><script>
 var drop = document.getElementById('drop'),
     files = document.getElementById('files'),
     label = document.getElementById('drop-label');
 function count() {{
   if (files.files.length)
     label.textContent = files.files.length + ' file(s) selected';
 }}
 drop.addEventListener('click', function () {{ files.click(); }});
 files.addEventListener('change', count);
 ['dragover', 'dragenter'].forEach(function (ev) {{
   drop.addEventListener(ev, function (e) {{
     e.preventDefault(); drop.classList.add('hover');
   }});
 }});
 ['dragleave', 'dragend'].forEach(function (ev) {{
   drop.addEventListener(ev, function () {{ drop.classList.remove('hover'); }});
 }});
 drop.addEventListener('drop', function (e) {{
   e.preventDefault(); drop.classList.remove('hover');
   files.files = e.dataTransfer.files; count();
 }});
 document.getElementById('langs').addEventListener('click', function (e) {{
   var b = e.target.closest('button'); if (!b) return;
   this.querySelectorAll('button').forEach(function (x) {{
     x.classList.remove('active');
   }});
   b.classList.add('active');
   document.getElementById('lang').value = b.dataset.lang;
 }});
</script></body></html>"""

_INTRO = """<p>Upload Touhou character fanart and the ViT-Large model
(trained on the filtered Pixiv corpus) predicts which of the 120 characters
it shows. Concurrent requests are batched into one forward on the GPU.</p>"""


def handler(request: Request) -> Response:
    flashes: list[str] = []
    cards: list[str] = []
    lang = request.form_value("lang", DEFAULT_LABEL_LANG)

    if request.method == "POST":
        from PIL import Image

        images, filenames = [], []
        for _field, filename, data in request.files:
            if filename and data:
                try:
                    im = Image.open(BytesIO(data))
                    # force the decode NOW: Image.open only parses the
                    # header, so a truncated file would otherwise explode
                    # inside the batched predict and fail every other image
                    # in the upload instead of just this one
                    im.load()
                    images.append(im)
                    filenames.append(filename)
                except Exception as e:
                    flashes.append(f'<p class="error">Error reading {escape(filename)}: {escape(str(e))}</p>')
        urls_string = request.form_value("urls", "")
        for url in (u.strip() for u in urls_string.splitlines()):
            if not url:
                continue
            try:
                import requests

                r = requests.get(url, stream=True, timeout=20)
                r.raise_for_status()
                im = Image.open(BytesIO(r.content))
                im.load()  # same eager-decode rationale as the file branch
                images.append(im)
                filenames.append(url.split("/")[-1])
            except Exception as e:
                flashes.append(f'<p class="error">Error fetching URL {escape(url)}: {escape(str(e))}</p>')

        if not images:
            flashes.append('<p class="error">No valid files or URLs were provided.</p>')
        else:
            try:
                predictions, _ = serve_batch(images, target_lang=lang)
                for img, (label, confidence), fname in zip(images, predictions, filenames):
                    buf = BytesIO()
                    img.convert("RGB").save(buf, format="JPEG")
                    b64 = base64.b64encode(buf.getvalue()).decode()
                    cards.append(
                        '<div class="card">'
                        f'<img src="data:image/jpeg;base64,{b64}">'
                        f'<div class="pred">{escape(label)}\n{confidence:.1%}</div>'
                        f'<div>{escape(fname)}</div></div>'
                    )
                flashes.append(
                    f'<p class="flash">Classification complete for {len(cards)} image(s)!</p>'
                )
            except Exception as e:
                flashes.append(f'<p class="error">An error occurred: {escape(str(e))}</p>')

    if is_daemon_running():
        device_mode = "GPU" if is_daemon_accelerated() else "CPU"
    else:
        device_mode = "Inactive"

    html = _PAGE.format(
        device_mode=device_mode,
        device_on=" on" if device_mode != "Inactive" else "",
        flashes="".join(flashes),
        cards="".join(cards),
        intro=_INTRO if not cards else "",
        lang=escape(lang, quote=True),
        jp='class="active"' if lang == "JP" else "",
        cn='class="active"' if lang == "CN" else "",
        en='class="active"' if lang == "EN" else "",
    )
    return Response(html)


app = make_wsgi_app(handler)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Run the web demo.")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model: cuda (default) or "
                             "cpu")
    # default=None so an EXPLICIT --port 20810 is distinguishable from the
    # default (--debug used to silently remap an explicit 20810 to 80)
    parser.add_argument("--port", type=int, default=None,
                        help="default 20810 (80 with --debug)")
    args = parser.parse_args()
    runtime.DEVICE = args.device
    if args.debug:
        from wsgiref.simple_server import make_server

        make_server("0.0.0.0", args.port or 80, app).serve_forever()
    else:
        port = args.port or 20810
        serve_dual_stack(app, port, port + 1)  # 20810 / 20811
