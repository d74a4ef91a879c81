"""REST TTS server with continuous batching, stdlib only (the port of
zonos_tpu/serving/server.py).  Endpoints:

- ``POST /v1/tts``          JSON in, ``audio/wav`` out (batched transparently)
- ``POST /v1/tts/stream``   JSON in, chunked 16-bit PCM out while decoding
- ``POST /v1/speakers``     reference clip (wav body) in, ``speaker_id`` out
- ``GET  /v1/health``       liveness + model name
- ``GET  /v1/stats``        batcher counters (batches, audio-s, gen-s, queue)

JSON request fields for /v1/tts and /v1/tts/stream (all optional but text):
``text, language, speaker_id, emotion[8], fmax, pitch_std, speaking_rate,
vqscore_8[8], ctc_loss, dnsmos_ovrl, speaker_noised, unconditional_keys[],
cfg_scale, seed, max_seconds, deadline_s, sampling{temperature, top_p,
top_k, min_p, linear, conf, quad, repetition_penalty,
repetition_penalty_window}``.  /v1/tts additionally takes ``long`` (split
arbitrary-length text into duration-budgeted segments), with
``max_segment_seconds``, ``carry`` (default true: sequential audio-prefix
voice continuity, bit-identical to the offline ``zonos_tpu_torch.longform``
path; false: parallel segments + crossfade joins) and ``carry_frames``;
/v1/tts/stream additionally takes ``chunk_frames`` and ``margin_frames``.

Run: ``python -m zonos_tpu_torch.serving [--device cuda] [--port 8600]
[--model ...]``.  The flags that differ from JAX's server: ``--kv_int8``,
``--kv_f8`` and ``--ssm_bf16`` set ``Zonos.set_storage`` (JAX reads
environment variables at trace time); ``--compile_cache`` is gone (there is
no XLA cache; the kernels build once into ``build/zonos_tpu_torch/``);
``--device`` picks the card (the default, ``cuda``, raises without one).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from zonos_tpu_torch.conditioning import make_cond_dict, prepare_cond_inputs
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.serving.batching import (
    ContinuousBatcher,
    ServerOverloaded,
    StreamRequest,
    TTSRequest,
    program_frames_bucket,
)

MAX_FRAMES = 86 * 30  # model hard cap: 30 s of audio (zonos/model.py:229)


def wav_bytes(wav: np.ndarray, sr: int = 44100) -> bytes:
    """float waveform [.., samples] -> 16-bit PCM WAV container bytes."""
    pcm = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def _crossfade_concat(wavs: list, sr: int, fade_ms: float = 20.0):
    """Concatenate waveforms with a short linear crossfade at each seam."""
    wavs = [w for w in wavs if w.size]
    if not wavs:
        raise RuntimeError("all segments produced no audio")
    out = wavs[0]
    for w in wavs[1:]:
        n = int(min(fade_ms * sr / 1000.0, out.shape[-1] // 2, w.shape[-1] // 2))
        if n <= 0:
            out = np.concatenate([out, w])
            continue
        ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
        seam = out[-n:] * (1.0 - ramp) + w[:n] * ramp
        out = np.concatenate([out[:-n], seam, w[n:]])
    return out


class ServerState:
    """Model + batcher + speaker store shared across handler threads."""

    def __init__(self, model, model_name: str = "", **batcher_kwargs):
        self.model = model
        self.model_name = model_name
        # one card: the batcher's batches and stream chunks, long-form vocodes
        # and speaker embeddings must not interleave (a generate captures CUDA
        # graphs, and a capture fails if another thread uses the card)
        self.device_lock = threading.Lock()
        self.batcher = ContinuousBatcher(model, device_lock=self.device_lock,
                                         **batcher_kwargs)
        self.speakers: dict[str, np.ndarray] = {}

    def close(self):
        self.batcher.close()

    # -- request -> framework objects ------------------------------------
    def _speaker_from_json(self, body: dict):
        sid = body.get("speaker_id")
        if sid is None:
            return None
        speaker = self.speakers.get(sid)
        if speaker is None:
            raise ValueError(f"unknown speaker_id {sid!r}; POST /v1/speakers first")
        return speaker

    @staticmethod
    def _cond_kwargs_from_json(body: dict, with_language: bool = True) -> dict:
        keys = ("emotion", "fmax", "pitch_std", "speaking_rate",
                "vqscore_8", "ctc_loss", "dnsmos_ovrl", "speaker_noised")
        if with_language:
            keys = ("language",) + keys
        kwargs = {k: body[k] for k in keys if k in body}
        if "unconditional_keys" in body:
            kwargs["unconditional_keys"] = frozenset(body["unconditional_keys"])
        return kwargs

    def cond_dict_from_json(self, body: dict) -> dict:
        text = body.get("text")
        if not text or not isinstance(text, str):
            raise ValueError("'text' (non-empty string) is required")
        return make_cond_dict(text=text, speaker=self._speaker_from_json(body),
                              **self._cond_kwargs_from_json(body))

    def request_from_json(self, body: dict) -> TTSRequest:
        sampling = SamplingParams(**body.get("sampling", {}))
        max_seconds = float(body.get("max_seconds", 30.0))
        frames = max(9, min(MAX_FRAMES, int(max_seconds * 86)))
        deadline = body.get("deadline_s")
        return TTSRequest(
            cond_dict=self.cond_dict_from_json(body),
            sampling=sampling,
            cfg_scale=float(body.get("cfg_scale", 2.0)),
            seed=int(body.get("seed", 423)),
            max_new_tokens=frames,
            deadline_s=None if deadline is None else float(deadline),
        )

    def stream_request_from_json(self, body: dict) -> StreamRequest:
        r = self.request_from_json(body)
        margin = int(body.get("margin_frames", 32))
        with self.device_lock:  # the first use builds the codec on the card
            rf = self.model.autoencoder.receptive_field_frames
        if margin < rf:
            # validate BEFORE the 200 status line goes out: the generator
            # would only raise at first next() inside the stream worker
            raise ValueError(
                f"margin_frames={margin} is below the DAC decoder's "
                f"receptive half-width ({rf} frames)")
        return StreamRequest(
            cond_dict=r.cond_dict,
            sampling=r.sampling,
            cfg_scale=r.cfg_scale,
            seed=r.seed,
            max_new_tokens=r.max_new_tokens,
            deadline_s=r.deadline_s,
            chunk_frames=int(body.get("chunk_frames", 43)),
            margin_frames=margin,
        )

    def synthesize_long(self, body: dict) -> np.ndarray:
        """``"long": true`` requests.

        Default (``"carry": true``): segments are generated SEQUENTIALLY,
        each continuing from the previous segment's last ``carry_frames``
        codes (audio-prefix voice/prosody continuity) and vocoded WITH that
        carried context attached — the exact seam discipline of
        ``zonos_tpu_torch.longform.synthesize_long``, routed through the
        continuous batcher (segments still co-batch with other traffic;
        carry segments share one prefix-length bucket).  Output is
        bit-identical to the offline path under the same seed
        (tests/test_torch_port_server.py).  A non-default ``carry_frames``
        (or a first segment shorter than it) forms its own prefix-length
        bucket.

        ``"carry": false``: the parallel mode — all segments are
        submitted up front (they batch with each other), decoded raw, and
        joined with a short crossfade.  Higher throughput, no cross-seam
        voice carry.  Loudness is normalized ONCE on the joined result in
        both modes."""
        text = body.get("text")
        if not text or not isinstance(text, str):
            raise ValueError("'text' (non-empty string) is required")
        budget = float(body.get("max_segment_seconds", 25.0))
        if not 0 < budget <= 29.0:
            raise ValueError("max_segment_seconds must be in (0, 29] "
                             "(the model caps one generation at 30 s)")
        if body.get("carry", True):
            wav = self._synthesize_long_carry(body, budget)
        else:
            wav = self._synthesize_long_parallel(body, budget)
        return self.model.autoencoder.normalize_loudness(wav, 44100, target_lufs=-23.0)

    def _synthesize_long_carry(self, body: dict, budget: float) -> np.ndarray:
        from zonos_tpu_torch import longform

        # per-segment frame budget from the SEGMENT cap (+20% slack for the
        # rate estimate — same rule as the parallel mode), snapped to the
        # program-size bucket the batcher would use anyway; the offline
        # seam-identity test passes the same value to longform directly
        base = self.request_from_json(
            {**body, "max_seconds": min(budget * 1.2 + 1.0, 30.0)})
        carry_frames = int(body.get("carry_frames", 43))
        max_tokens = program_frames_bucket(base.max_new_tokens)
        # ONE deadline for the whole long-form request: segments run
        # sequentially, so each gets the REMAINING time, not a fresh window
        # (re-anchoring per segment would let a 10-segment request overrun
        # a 5 s deadline 10-fold)
        deadline_abs = (None if base.deadline_s is None
                        else time.monotonic() + float(base.deadline_s))

        def gen_via_batcher(cond, prefix_codes, seg_seed, max_new_tokens, _cb):
            remaining = None
            if deadline_abs is not None:
                remaining = deadline_abs - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("deadline_s exceeded during long-form synthesis")
            req = TTSRequest(
                cond_dict=cond,
                sampling=base.sampling,
                cfg_scale=base.cfg_scale,
                seed=seg_seed,
                max_new_tokens=max_new_tokens,
                codes_only=True,
                audio_prefix_codes=prefix_codes,
                deadline_s=remaining,
            )
            timeout = 600.0 if remaining is None else min(600.0, remaining + 5.0)
            return self.batcher.submit(req).wait(timeout=timeout)

        def decode_with_lock(dec_in):
            with self.device_lock:
                return np.asarray(self.model.autoencoder.decode(dec_in[None, ...])[0, 0])

        speaker = self._speaker_from_json(body)
        overrides = self._cond_kwargs_from_json(body, with_language=False)
        wav, _codes = longform.synthesize_long(
            self.model,
            body["text"],
            language=body.get("language", "en-us"),
            speaker=speaker,
            cond_overrides=overrides,
            sampling_params=base.sampling,
            cfg_scale=base.cfg_scale,
            seed=int(body.get("seed", 423)),
            max_segment_seconds=budget,
            carry_frames=carry_frames,
            max_new_tokens=max_tokens,
            generate_fn=gen_via_batcher,
            decode_fn=decode_with_lock,
        )
        return np.asarray(wav, np.float32).reshape(-1)

    def _synthesize_long_parallel(self, body: dict, budget: float) -> np.ndarray:
        from zonos_tpu_torch.longform import segment_texts

        segments = segment_texts(body["text"], body.get("language", "en-us"),
                                 float(body.get("speaking_rate", 15.0)),
                                 budget)

        base_seed = int(body.get("seed", 423))
        # per-segment frame budget from the SEGMENT cap (+20% slack for the
        # rate estimate), never the request-level max_seconds — that would
        # silently cut segments mid-sentence
        seg_body = {**body, "max_seconds": min(budget * 1.2 + 1.0, 30.0)}
        pending = []
        for i, seg in enumerate(segments):
            req = self.request_from_json(
                {**seg_body, "text": seg, "seed": base_seed + i})
            req.raw_decode = True
            pending.append(self.batcher.submit(req))
        wavs = [np.asarray(p.wait(timeout=600), np.float32).reshape(-1)
                for p in pending]
        return _crossfade_concat(wavs, sr=44100, fade_ms=20.0)


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):  # quiet
            pass

        # -- helpers -----------------------------------------------------
        def _json_body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _error(self, code: int, msg: str):
            self._send_json(code, {"error": msg})

        # -- routes ------------------------------------------------------
        def do_GET(self):
            if self.path == "/v1/health":
                self._send_json(200, {"status": "ok", "model": state.model_name})
            elif self.path == "/v1/stats":
                self._send_json(200, state.batcher.snapshot())
            else:
                self._error(404, "not found")

        def do_POST(self):
            try:
                if self.path == "/v1/tts":
                    self._tts()
                elif self.path == "/v1/tts/stream":
                    self._tts_stream()
                elif self.path == "/v1/speakers":
                    self._register_speaker()
                else:
                    self._error(404, "not found")
            except (ValueError, AssertionError, json.JSONDecodeError) as e:
                self._error(400, str(e))
            except ServerOverloaded as e:
                # load shedding: tell the client when to come back instead
                # of stalling it behind a saturated queue
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", str(int(round(e.retry_after))))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except TimeoutError as e:
                self._error(504, str(e))
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                self._error(500, f"{type(e).__name__}: {e}")

        def _tts(self):
            body = self._json_body()
            if body.get("long"):
                wav = state.synthesize_long(body)
            else:
                wav = state.batcher.synthesize(state.request_from_json(body),
                                               timeout=600)
            self._send(200, wav_bytes(wav), "audio/wav")

        def _tts_stream(self):
            """Chunked-transfer raw 16-bit PCM (44.1 kHz mono), emitted while
            the decode loop runs.  Streams go through the continuous batcher
            (``ContinuousBatcher.submit_stream``): concurrent stream requests
            ride one batched decode (same window) or interleave chunk-wise
            (separate groups) — the handler never holds the device lock."""
            body = self._json_body()
            if body.get("long"):
                raise ValueError(
                    "'long' is not supported on /v1/tts/stream (one "
                    "generation streams at most 30 s); use /v1/tts with "
                    "'long': true, or stream per-segment client-side")
            req = state.stream_request_from_json(body)
            # everything that can fail with a clean 4xx runs BEFORE the
            # status line goes out (batcher-side validation errors surface
            # on the first chunks() pull, after headers — so pre-validate)
            prepare_cond_inputs(state.model.specs, req.cond_dict)
            handle = state.batcher.submit_stream(req)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Sample-Rate", "44100")
            self.send_header("X-Sample-Format", "s16le")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

            try:
                for piece in handle.chunks(timeout=600.0):
                    pcm = np.clip(np.asarray(piece, np.float32).reshape(-1), -1, 1)
                    chunk((pcm * 32767.0).astype("<i2").tobytes())
                self.wfile.write(b"0\r\n\r\n")
            except BrokenPipeError:
                handle.cancel()  # client hung up: stop delivery, free a
                # fully-cancelled batch early
                self.close_connection = True
            except Exception:  # noqa: BLE001
                # headers are already out: writing a second HTTP response
                # into the chunked body would corrupt the stream (the client
                # parses the status line as a chunk size) — drop the
                # connection so it sees truncation
                logging.getLogger("zonos_tpu_torch.serving").exception(
                    "stream aborted mid-generation"
                )
                handle.cancel()
                self.close_connection = True

        def _register_speaker(self):
            """Body: WAV bytes (Content-Type audio/wav).  Returns a content-
            addressed speaker_id for later /v1/tts calls (embedding computed
            once — the voice-DB caching semantics of zonos/speaker_utils.py)."""
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            if not raw:
                raise ValueError("empty body; send a WAV file")
            sid = hashlib.sha256(raw).hexdigest()[:16]
            if sid not in state.speakers:
                with wave.open(io.BytesIO(raw), "rb") as w:
                    sr = w.getframerate()
                    n = w.getnframes()
                    ch = w.getnchannels()
                    width = w.getsampwidth()
                    frames = w.readframes(n)
                if width != 2:
                    raise ValueError("only 16-bit PCM WAV is supported")
                pcm = np.frombuffer(frames, "<i2").astype(np.float32) / 32768.0
                pcm = pcm.reshape(-1, ch).mean(axis=1)[None, :]
                with state.device_lock:
                    emb = state.model.make_speaker_embedding(pcm, sr)
                state.speakers[sid] = emb
            self._send_json(200, {"speaker_id": sid})

    return Handler


def serve(
    state: ServerState, host: str = "0.0.0.0", port: int = 8600, background: bool = True
) -> ThreadingHTTPServer:
    """Build the HTTP server; ``background=True`` also starts serving on a
    daemon thread (``main()`` reuses this with ``background=False`` and runs
    ``serve_forever`` in the foreground itself)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    if background:
        thread = threading.Thread(target=httpd.serve_forever, name="tts-http", daemon=True)
        thread.start()
    return httpd


def main(argv=None) -> None:
    import argparse

    from zonos_tpu_torch.apps.common import load_model

    ap = argparse.ArgumentParser(description="zonos-tpu TTS server (PyTorch/CUDA port)")
    ap.add_argument("--model", default="Zyphra/Zonos-v0.1-transformer")
    ap.add_argument("--backbone", default=None, choices=[None, "transformer", "hybrid"])
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; raises without a card)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=30.0)
    ap.add_argument("--max_queue", type=int, default=64,
                    help="in-flight request bound; beyond it requests get 503 + Retry-After")
    ap.add_argument("--int8", action="store_true", help="quantize weights for serving")
    ap.add_argument("--kv_int8", action="store_true",
                    help="int8 KV cache (lossy; halves cache reads at large batch)")
    ap.add_argument("--kv_f8", action="store_true",
                    help="float8 (e4m3) KV cache: int8's savings without per-row scales")
    ap.add_argument("--ssm_bf16", action="store_true", help="bf16 Mamba2 SSM states (lossy)")
    ap.add_argument("--warmup", action="store_true",
                    help="load the kernels and run one short generate per batch bucket, "
                         "cond-length bucket and prefix length before serving")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.kv_int8 and args.kv_f8:
        ap.error("--kv_int8 and --kv_f8 are exclusive")
    if args.backbone is None:
        args.backbone = "hybrid" if "hybrid" in args.model else "transformer"

    model = load_model(args)
    if args.int8:
        model.quantize_int8()
    kv = "int8" if args.kv_int8 else "f8" if args.kv_f8 else None
    model.set_storage(kv=kv, ssm="bf16" if args.ssm_bf16 else None)
    state = ServerState(model, model_name=args.model,
                        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                        max_queue=args.max_queue)
    if args.warmup:
        print("warming the kernels and the serving shapes ...")
        # prefix length 43 = the long-form carry default
        n = state.batcher.warmup(prefix_audio_lens=(0, 43))
        n += state.batcher.warmup_streaming()
        print(f"warmup done: {n} generates and decodes run")
    httpd = serve(state, args.host, args.port, background=False)
    print(f"serving on http://{args.host}:{args.port}  (POST /v1/tts)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.close()


if __name__ == "__main__":
    main()
