"""Demo HTTP server: a browser page and a synthesis API.

    python -m nspeech_tpu_torch.cli.demo_server --checkpoint CKPT_DIR \
        [--vocoder-checkpoint VOC_DIR] [--dynamic-batch N] [--warmup]
    python -m nspeech_tpu_torch.cli.demo_server --artifact ARTIFACT_DIR \
        [--dynamic-batch N]

Port of the JAX package's ``demo_server.py`` on stdlib WSGI, with its
routes, status codes and bodies:

- ``GET /``: the page; ``GET /stats``: uptime, per-route counts and the
  batchers' ``stats``;
- ``GET /synthesize?text=...&speaker_id=N``: one WAV;
- ``GET /synthesize_stream?text=...``: a WAV header with unknown sizes,
  then PCM chunks as the stream makes them (needs a vocoder, else 404);
- ``POST /synthesize_batch`` with JSON ``{"texts": [...],
  "speaker_ids": [...]}``: a zip of WAVs.

Missing text, a non-integer ``speaker_id`` or a ``ClientError`` give 400.
With ``--dynamic-batch N``, concurrent ``/synthesize`` requests share one
padded forward and one sampler launch (``DynamicBatcher``) and
concurrent streams one carried launch per chunk (``StreamBatcher``). The
server runs on the card unless ``--device cpu``. With ``--artifact`` it
serves ``/synthesize`` and ``/synthesize_batch`` from an exported
text -> waveform program (``serving/export.py``, Griffin-Lim); a text
beyond the artifact's ``text_len`` gets a 400. ``--data-parallel`` shards
each batched forward over every card (``Synthesizer(mesh=...)``).
"""

from __future__ import annotations

import argparse
import inspect
import io
import json
import time
import zipfile
from socketserver import ThreadingMixIn
from types import SimpleNamespace
from urllib.parse import parse_qs
from wsgiref import simple_server

from nspeech_tpu_torch.config import debug_string
from nspeech_tpu_torch.dsp.wavio import (encode_pcm16, encode_wav_bytes,
                                         wav_stream_header)
from nspeech_tpu_torch.parallel.mesh import local_mesh
from nspeech_tpu_torch.serving import (ClientError, DynamicBatcher,
                                       ExportedSynthesizer, StreamBatcher,
                                       StreamingTTS, Synthesizer, TextToSpeech,
                                       WaveNetVocoder)

HTML_BODY = b"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>nspeech-tpu</title>
<style>
  :root { --bg: #12151a; --card: #1c2128; --ink: #d6dde6; --dim: #78828e;
          --accent: #4fb07a; --err: #d97066; }
  * { box-sizing: border-box; margin: 0; }
  body { background: var(--bg); color: var(--ink); min-height: 100vh;
         display: grid; place-items: center;
         font: 15px/1.5 ui-monospace, "SF Mono", Menlo, monospace; }
  main { background: var(--card); border-radius: 10px; padding: 2rem;
         width: min(34rem, 92vw); }
  h1 { font-size: 1.05rem; font-weight: 600; letter-spacing: .06em;
       text-transform: uppercase; color: var(--accent); }
  h1 small { color: var(--dim); font-weight: 400; text-transform: none;
             letter-spacing: 0; margin-left: .5rem; }
  textarea { width: 100%; margin-top: 1.2rem; resize: vertical;
             background: var(--bg); color: var(--ink); border: 1px solid #2c333c;
             border-radius: 6px; padding: .7rem; font: inherit; min-height: 4.5rem; }
  textarea:focus { border-color: var(--accent); outline: none; }
  .row { display: flex; gap: .8rem; align-items: center; margin-top: .9rem; }
  label { color: var(--dim); font-size: .85rem; }
  #spk { width: 4.5rem; background: var(--bg); color: var(--ink);
         border: 1px solid #2c333c; border-radius: 6px; padding: .35rem .5rem;
         font: inherit; }
  #go { margin-left: auto; background: var(--accent); color: #0b0e11;
        border: 0; border-radius: 6px; padding: .55rem 1.4rem; font: inherit;
        font-weight: 600; cursor: pointer; }
  #go:disabled { filter: grayscale(1); opacity: .5; cursor: wait; }
  #status { margin-top: 1rem; min-height: 1.4rem; color: var(--dim); }
  #status.error { color: var(--err); }
  audio { width: 100%; margin-top: .6rem; display: none; }
  audio.ready { display: block; }
</style>
</head>
<body>
<main>
  <h1>nspeech-tpu<small>text &rarr; speech</small></h1>
  <textarea id="utt" placeholder="Type a sentence to synthesize&hellip;"
            autofocus></textarea>
  <div class="row">
    <label for="spk">speaker</label>
    <input id="spk" type="number" value="-1" min="-1">
    <label><input id="live" type="checkbox"> stream</label>
    <button id="go">Synthesize</button>
  </div>
  <div id="status"></div>
  <audio id="player" controls></audio>
</main>
<script>
  const el = id => document.getElementById(id);

  async function speak() {
    const text = el('utt').value.trim();
    if (!text) { return; }
    const route = el('live').checked ? '/synthesize_stream' : '/synthesize';
    const url = route + '?text=' + encodeURIComponent(text) +
                '&speaker_id=' + encodeURIComponent(el('spk').value || '-1');
    el('go').disabled = true;
    el('status').className = '';
    el('status').textContent = 'synthesizing\\u2026';
    el('player').className = '';
    const t0 = performance.now();
    try {
      if (el('live').checked) {
        // progressive playback: the browser starts as chunks arrive
        // (needs the server started with --vocoder-checkpoint)
        el('player').src = url + '&t=' + Date.now();
        el('player').className = 'ready';
        await el('player').play();
        const dt = ((performance.now() - t0) / 1000).toFixed(2);
        el('status').textContent = 'first audio in ' + dt + ' s (streaming)';
      } else {
        const res = await fetch(url);
        if (!res.ok) { throw new Error(await res.text() || res.statusText); }
        el('player').src = URL.createObjectURL(await res.blob());
        el('player').className = 'ready';
        el('player').play();
        const dt = ((performance.now() - t0) / 1000).toFixed(2);
        el('status').textContent = 'done in ' + dt + ' s';
      }
    } catch (err) {
      el('status').className = 'error';
      el('status').textContent = String(err.message || err);
    } finally {
      el('go').disabled = false;
    }
  }

  el('go').addEventListener('click', speak);
  el('utt').addEventListener('keydown', ev => {
    if (ev.key === 'Enter' && !ev.shiftKey) { ev.preventDefault(); speak(); }
  });
</script>
</body>
</html>
"""

KNOWN_ROUTES = frozenset(("/", "/stats", "/synthesize_stream", "/synthesize",
                          "/synthesize_batch"))


def _takes_want_features(synthesizer) -> bool:
    """Whether ``synthesize`` can skip the mel/linear device->host copies
    (``Synthesizer`` and ``TextToSpeech`` can, a batcher cannot)."""
    return "want_features" in inspect.signature(synthesizer.synthesize).parameters


def _text_and_speaker(environ, start_response):
    """``(text, speaker_id, None)`` from the query, or ``(None, None,
    body)`` after a 400."""
    params = parse_qs(environ.get("QUERY_STRING", ""))
    text = (params.get("text") or [""])[0]
    if not text:
        start_response("400 Bad Request", [("Content-Type", "text/plain")])
        return None, None, [b"missing ?text="]
    try:
        speaker_id = int((params.get("speaker_id") or ["-1"])[0])
    except ValueError:
        start_response("400 Bad Request", [("Content-Type", "text/plain")])
        return None, None, [b"speaker_id must be an integer"]
    return text, speaker_id, None


def _bad_request(start_response, message: bytes):
    start_response("400 Bad Request", [("Content-Type", "text/plain")])
    return [message]


def make_app(synthesizer, cfg, streamer=None):
    """The WSGI app. ``synthesizer`` has ``synthesize(text, speaker_id) ->
    (wav, mel, lin)`` (a ``Synthesizer``, ``TextToSpeech`` or
    ``DynamicBatcher``); ``streamer`` has ``stream(text, speaker_id)``
    (``StreamingTTS`` or ``StreamBatcher``), or is None."""
    counters = {"started": time.time(), "routes": {}}
    wav_only = _takes_want_features(synthesizer)

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        # known routes by name, everything else in one bucket, so that a
        # URL scanner cannot grow the dict
        key = path if path in KNOWN_ROUTES else "other"
        counters["routes"][key] = counters["routes"].get(key, 0) + 1
        if path == "/":
            start_response("200 OK", [("Content-Type", "text/html")])
            return [HTML_BODY]
        if path == "/stats":
            payload = {"uptime_sec": round(time.time() - counters["started"], 1),
                       "routes": counters["routes"]}
            if hasattr(synthesizer, "stats"):
                payload["dynamic_batching"] = dict(synthesizer.stats)
            if streamer is not None and hasattr(streamer, "stats"):
                payload["stream_batching"] = dict(streamer.stats)
            body = json.dumps(payload).encode("utf-8")
            start_response("200 OK", [("Content-Type", "application/json"),
                                      ("Content-Length", str(len(body)))])
            return [body]
        if path == "/synthesize_stream":
            if streamer is None:
                start_response("404 Not Found", [("Content-Type", "text/plain")])
                return [b"streaming needs a WaveNet vocoder "
                        b"(--vocoder-checkpoint)"]
            text, speaker_id, error = _text_and_speaker(environ, start_response)
            if error is not None:
                return error
            # start the stream before committing to 200, so that a
            # rejected input still gets its 400
            try:
                chunks = streamer.stream(text, speaker_id)
                first = next(chunks, None)
            except ClientError as e:
                return _bad_request(start_response, str(e).encode("utf-8"))
            # no Content-Length: chunks leave as the card makes them
            start_response("200 OK", [("Content-Type", "audio/wav")])

            def body():
                yield wav_stream_header(cfg.sample_rate)
                if first is None:
                    return
                yield encode_pcm16(first)
                try:
                    for chunk in chunks:
                        yield encode_pcm16(chunk)
                except Exception as e:  # the 200 is on the wire: truncate
                    print("synthesize_stream aborted mid-body: %s" % e)

            return body()
        if path == "/synthesize":
            text, speaker_id, error = _text_and_speaker(environ, start_response)
            if error is not None:
                return error
            try:
                if wav_only:   # this route ships the wav alone
                    wav, _, _ = synthesizer.synthesize(text, speaker_id,
                                                       want_features=False)
                else:
                    wav, _, _ = synthesizer.synthesize(text, speaker_id)
            except ClientError as e:
                return _bad_request(start_response, str(e).encode("utf-8"))
            body = encode_wav_bytes(wav, cfg.sample_rate)
            start_response("200 OK", [("Content-Type", "audio/wav"),
                                      ("Content-Length", str(len(body)))])
            return [body]
        if path == "/synthesize_batch":
            try:
                size = int(environ.get("CONTENT_LENGTH") or 0)
                payload = json.loads(environ["wsgi.input"].read(size).decode("utf-8"))
                texts = payload["texts"]
                speaker_ids = payload.get("speaker_ids")
            except Exception:
                return _bad_request(start_response,
                                    b'POST JSON {"texts": [...]} required')
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) and t for t in texts)):
                return _bad_request(
                    start_response,
                    b"texts must be a non-empty list of non-empty strings")
            if speaker_ids is not None and (
                    not isinstance(speaker_ids, list)
                    or len(speaker_ids) != len(texts)
                    or not all(isinstance(s, int) and not isinstance(s, bool)
                               for s in speaker_ids)):
                return _bad_request(start_response,
                                    b"speaker_ids must be a list of integers "
                                    b"matching texts in length")
            try:
                wavs, _, _ = synthesizer.synthesize_batch(texts, speaker_ids)
            except ClientError as e:
                # only a rejected input is the client's fault; anything
                # else stays a server fault
                return _bad_request(start_response, str(e).encode("utf-8"))
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as z:
                for i, wav in enumerate(wavs):
                    z.writestr("utt_%03d.wav" % i,
                               encode_wav_bytes(wav, cfg.sample_rate))
            body = buf.getvalue()
            start_response("200 OK", [("Content-Type", "application/zip"),
                                      ("Content-Length", str(len(body)))])
            return [body]
        start_response("404 Not Found", [("Content-Type", "text/plain")])
        return [b"not found"]

    return app


class _ThreadedServer(ThreadingMixIn, simple_server.WSGIServer):
    daemon_threads = True


def make_server(app, port: int, host: str = "0.0.0.0") -> simple_server.WSGIServer:
    """A threaded WSGI server bound to (host, port); port 0 takes a free
    one (``server.server_port``). Requests run concurrently: a long stream
    does not block /synthesize, and the batcher sees more than one request
    per window."""
    return simple_server.make_server(host, port, app,
                                     server_class=_ThreadedServer)


def serve_forever(app, port: int) -> None:
    make_server(app, port).serve_forever()


def _maybe_batch(synthesizer, args):
    if args.dynamic_batch > 0:
        print("Dynamic batching: up to %d requests per %.0f ms window"
              % (args.dynamic_batch, args.batch_window_ms))
        return DynamicBatcher(synthesizer, max_batch=args.dynamic_batch,
                              window_ms=args.batch_window_ms)
    return synthesizer


def _warmup(synthesizer, streamer, args) -> None:
    """Run every surface a first request could hit once: the sampler
    builds (nvcc) and cuDNN plans its shapes before the first caller
    waits. The wav-only and full single paths, the largest dynamic batch,
    and (with streaming) a single stream and the largest stream batch."""
    text = "warm up the serving programs."
    t0 = time.monotonic()
    print("Warmup: single synthesize ...", flush=True)
    if _takes_want_features(synthesizer):
        synthesizer.synthesize(text, -1, want_features=False)
    synthesizer.synthesize(text, -1)
    if args.dynamic_batch > 1 and hasattr(synthesizer, "synthesize_batch"):
        print("Warmup: batch-%d synthesize ..." % args.dynamic_batch, flush=True)
        synthesizer.synthesize_batch([text] * args.dynamic_batch)
    if streamer is not None:
        tts = getattr(streamer, "_tts", streamer)   # unwrap a StreamBatcher
        print("Warmup: single stream ...", flush=True)
        for _ in tts.stream(text):
            pass
        if args.dynamic_batch > 1:
            print("Warmup: batch-%d stream ..." % args.dynamic_batch, flush=True)
            for _ in tts.stream_batch([text] * args.dynamic_batch):
                pass
    print("Warmup done in %.0f s" % (time.monotonic() - t0), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint directory (config.json + serving/)")
    parser.add_argument("--artifact", default=None,
                        help="Serve an exported artifact directory "
                        "(cli.export_serving) instead of a checkpoint")
    parser.add_argument("--checkpoint-step", type=int, default=None)
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--model", default=None,
                        help="Model name (default: checkpoint run metadata)")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--num-speakers", type=int, default=None)
    parser.add_argument("--vocoder-checkpoint", default=None,
                        help="WaveNet vocoder checkpoint dir (else Griffin-Lim)")
    parser.add_argument("--vocoder-model", default=None)
    parser.add_argument("--vocoder-hparams", default="")
    parser.add_argument("--stream-chunk-frames", type=int, default=40,
                        help="Mel frames per /synthesize_stream chunk "
                        "(0.5 s at the default 12.5 ms frame shift)")
    parser.add_argument("--dynamic-batch", type=int, default=0, metavar="N",
                        help="Batch concurrent /synthesize requests (up to "
                        "N) into one forward and one sampler launch, and "
                        "concurrent streams into one stream batch; 0 = off")
    parser.add_argument("--batch-window-ms", type=float, default=10.0,
                        help="How long the dynamic batcher waits for "
                        "companions after the first request")
    parser.add_argument("--warmup", action="store_true",
                        help="Build the sampler and run each serving surface "
                        "once at startup, so that first requests do not wait")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batched synthesis over every card (a "
                        "one-process device mesh); pairs well with "
                        "--dynamic-batch")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the sampler kernel) or cpu (plain)")
    args = parser.parse_args(argv)
    if bool(args.checkpoint) == bool(args.artifact):
        parser.error("exactly one of --checkpoint / --artifact is required")
    if args.artifact:
        if args.vocoder_checkpoint:
            raise SystemExit("--artifact serves the exported Griffin-Lim "
                             "program; --vocoder-checkpoint needs --checkpoint")
        synthesizer = ExportedSynthesizer(args.artifact, device=args.device)
        cfg = SimpleNamespace(sample_rate=synthesizer.meta["sample_rate"])
        app = make_app(_maybe_batch(synthesizer, args), cfg)
        print("Serving artifact %s on port %d" % (args.artifact, args.port))
        serve_forever(app, args.port)
        return
    overrides = args.hparams
    if args.num_speakers is not None:
        overrides = (overrides + "," if overrides else "") \
            + "num_speakers=%d" % args.num_speakers
    mesh = None
    if args.data_parallel:
        mesh = local_mesh(args.device)
        print("Serving data-parallel over %d devices" % mesh.devices.size)
    synthesizer = Synthesizer.from_checkpoint(
        args.checkpoint, args.model, overrides, step=args.checkpoint_step,
        device=args.device, mesh=mesh)
    cfg = synthesizer.cfg
    print(debug_string(cfg))
    streamer = None
    if args.vocoder_checkpoint:
        vocoder = WaveNetVocoder.from_checkpoint(
            args.vocoder_checkpoint, args.vocoder_model, args.vocoder_hparams,
            device=args.device)
        if vocoder.net.lc_channels > 0:
            streamer = StreamingTTS(synthesizer, vocoder,
                                    chunk_frames=args.stream_chunk_frames)
            if args.dynamic_batch > 0:
                print("Stream batching: up to %d concurrent streams per "
                      "%.0f ms window" % (args.dynamic_batch,
                                          args.batch_window_ms))
                streamer = StreamBatcher(streamer, max_batch=args.dynamic_batch,
                                         window_ms=args.batch_window_ms)
        synthesizer = TextToSpeech(synthesizer, vocoder)
    synthesizer = _maybe_batch(synthesizer, args)
    if args.warmup:
        _warmup(synthesizer, streamer, args)
    app = make_app(synthesizer, cfg, streamer=streamer)
    print("Serving on port %d" % args.port)
    serve_forever(app, args.port)


if __name__ == "__main__":
    main()
