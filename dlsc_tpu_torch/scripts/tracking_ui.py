"""Browse tracked runs (the reference serves MLflow UI via ngrok,
scripts/mlflow_ui.py:24-35; here runs are plain directories, so this serves
a minimal HTML index over http.server — no external tunnel dependency).

    python -m dlsc_tpu_torch.scripts.tracking_ui [--root runs] [--port 0] [--print]

The counterpart of ``scripts/tracking_ui.py`` on the port's tracker: the
same index and ``--print`` output for the same runs directory.
"""

from __future__ import annotations

import argparse
import http.server
import json
import socketserver
from pathlib import Path

from dlsc_tpu_torch.tracking.tracker import load_metrics


def render_index(root: Path) -> str:
    rows = []
    for exp in sorted(p for p in root.iterdir() if p.is_dir()):
        for run in sorted(p for p in exp.iterdir() if p.is_dir()):
            meta = {}
            mp = run / "meta.json"
            if mp.exists():
                meta = json.loads(mp.read_text())
            finals = {}
            for m in load_metrics(run):
                finals[m["name"]] = m["value"]
            keep = {k: round(v, 4) for k, v in finals.items()
                    if k in ("train/acc", "val/acc", "test/acc", "test/f1")}
            rows.append(
                f"<tr><td>{exp.name}</td><td>{run.name}</td>"
                f"<td>{meta.get('status', '?')}</td><td>{keep}</td></tr>"
            )
    return ("<html><body><h2>dlsc_tpu runs</h2><table border=1 "
            "cellpadding=4><tr><th>experiment</th><th>run</th><th>status</th>"
            "<th>final metrics</th></tr>" + "".join(rows) + "</table></body></html>")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="runs")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--print", dest="print_only", action="store_true",
                   help="print the run table to stdout and exit")
    args = p.parse_args(argv)
    root = Path(args.root)
    if not root.exists():
        raise SystemExit(f"no runs at {root}")
    if args.print_only:
        for exp in sorted(p for p in root.iterdir() if p.is_dir()):
            for run in sorted(p for p in exp.iterdir() if p.is_dir()):
                finals = {m["name"]: m["value"] for m in load_metrics(run)}
                keep = {k: round(v, 4) for k, v in finals.items()
                        if "acc" in k or "f1" in k}
                print(f"{exp.name}/{run.name}: {keep}")
        return

    html = render_index(root).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = render_index(root).encode() if self.path == "/" else html
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    with socketserver.TCPServer(("127.0.0.1", args.port), Handler) as httpd:
        print(f"serving run index at http://127.0.0.1:{httpd.server_address[1]}/")
        httpd.serve_forever()


if __name__ == "__main__":
    main()
