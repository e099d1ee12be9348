"""Minimal web demo for transcription: `python -m reverb_tpu_torch.cli.app`.

Counterpart of reverb_tpu/cli/app.py (reference asr/app.py, a gradio demo):
a dependency-free stdlib HTTP server.  POST a WAV to /transcribe and get
{"text": ...} back; GET / serves a tiny upload form.  The model is the
port's `load_model` on `--device` (default cuda; raises without a card).
"""

from __future__ import annotations

import argparse
import json
import tempfile
from http.server import BaseHTTPRequestHandler, HTTPServer

_PAGE = b"""<!doctype html><title>reverb-tpu demo</title>
<h2>reverb-tpu transcription demo</h2>
<form method=post enctype=multipart/form-data action=/transcribe>
<input type=file name=audio accept=.wav>
<button>Transcribe</button></form>"""


def make_handler(model, mode: str):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header('Content-Type', 'text/html')
            self.end_headers()
            self.wfile.write(_PAGE)

        def do_POST(self):
            length = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(length)
            # crude multipart extraction: find the WAV payload
            start = body.find(b'RIFF')
            if start < 0:
                self.send_error(400, 'no WAV payload found')
                return
            end = body.rfind(b'\r\n--')
            wav = body[start:end if end > start else len(body)]
            with tempfile.NamedTemporaryFile(suffix='.wav') as f:
                f.write(wav)
                f.flush()
                text = model.transcribe(f.name, mode=mode)
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.end_headers()
            self.wfile.write(json.dumps({'text': text}).encode())

        def log_message(self, *args):
            pass
    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description='reverb web demo (PyTorch)')
    p.add_argument('--model', required=True)
    p.add_argument('--port', type=int, default=7860)
    p.add_argument('--mode', default='ctc_prefix_beam_search')
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; raises without a card)')
    args = p.parse_args(argv)
    from reverb_tpu_torch.cli.reverb import load_model
    model = load_model(args.model, device=args.device)
    server = HTTPServer(('0.0.0.0', args.port),
                        make_handler(model, args.mode))
    print(f'demo listening on :{args.port}')
    server.serve_forever()


if __name__ == '__main__':
    main()
