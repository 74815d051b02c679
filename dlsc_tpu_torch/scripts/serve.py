"""Serve an artifact of the port over HTTP with micro-batched inference.

    python -m dlsc_tpu_torch.scripts.serve +artifact=exports/ast_torch \
        [+port=8000] [+host=127.0.0.1] [+device=cuda] [+window_ms=5] [+top_k=5]

Endpoints (see dlsc_tpu_torch/server.py): GET /healthz, POST /predict (WAV
bytes), POST /predict_raw (JSON {"pcm": [...], "sample_rate": N}).
"""

from __future__ import annotations

import sys

from dlsc_tpu_torch.config import compose
from dlsc_tpu_torch.scripts.train import parse_cli
from dlsc_tpu_torch.server import ModelServer


def main(argv: list[str] | None = None) -> None:
    cfg = compose(*parse_cli(list(argv if argv is not None else sys.argv[1:])))
    artifact = cfg.select("artifact", default=None)
    if not artifact:
        raise SystemExit("pass +artifact=<export dir> (from "
                         "python -m dlsc_tpu_torch.scripts.export)")
    server = ModelServer(
        str(artifact),
        device=str(cfg.select("device", default="cuda")),
        window_ms=float(cfg.select("window_ms", default=5.0)),
        top_k=int(cfg.select("top_k", default=5)),
    )
    host = str(cfg.select("host", default="127.0.0.1"))
    port = int(cfg.select("port", default=8000))
    httpd = server.make_http_server(host, port)
    print(f"serving {artifact} on http://{host}:{httpd.server_address[1]} "
          f"(batch {server.manifest['batch']}, "
          f"{server.manifest.get('num_classes', '?')} classes)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
