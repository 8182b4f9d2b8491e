"""Host-side CTC beam search with an n-gram LM (counterpart of
wav2vec2forbrain_tpu/decode/lm_decode.py).

The C++ core, native/ctc_beam_decoder.cc with native/kenlm_binary.h (the
port's own copies), is a pyctcdecode-flavoured prefix beam search over an
ARPA text model or a kenlm probing binary (told apart by their magic). It
is compiled with g++ at first use into ``build/decoder/<hash>/`` at the
repository root (git-ignored), keyed by a hash of the sources and flags,
and loaded with ctypes; a decode releases the GIL and runs its batch on
threads. A library that fails to build or load raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "decoder"
LIB_NAME = "libctc_beam_decoder.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()


def _sources():
    return sorted(p for p in NATIVE_DIR.iterdir() if p.suffix in (".cc", ".h"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the decoder into build/decoder/<hash>/ unless already built."""
    out = BUILD_ROOT / source_hash() / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, str(NATIVE_DIR / "ctc_beam_decoder.cc"), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the CTC beam decoder:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each publish a whole library
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ctc_decoder_create.restype = ctypes.c_void_p
            lib.ctc_decoder_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.ctc_decoder_destroy.argtypes = [ctypes.c_void_p]
            lib.ctc_decoder_lm_order.restype = ctypes.c_int
            lib.ctc_decoder_lm_order.argtypes = [ctypes.c_void_p]
            lib.ctc_decoder_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ]
            lib.ctc_decoder_free_strings.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
            _lib = lib
    return _lib


class CTCBeamDecoder:
    """Prefix beam search with an optional n-gram LM (ARPA text or kenlm
    probing binary)."""

    def __init__(
        self,
        vocab: List[str],
        blank_id: int = 0,
        word_delimiter_token: str = "|",
        lm_path: Optional[str] = None,
        alpha: float = 0.5,
        beta: float = 0.5,
        unk_score_offset: float = -10.0,
        score_boundary: bool = False,
    ):
        self._lib = _get_lib()
        c_vocab = (ctypes.c_char_p * len(vocab))(*[v.encode() for v in vocab])
        err = ctypes.create_string_buffer(512)
        self._handle = self._lib.ctc_decoder_create(
            c_vocab, len(vocab), blank_id, word_delimiter_token.encode(), (lm_path or "").encode(),
            alpha, beta, unk_score_offset, 1 if score_boundary else 0, err, len(err),
        )
        if not self._handle:
            raise RuntimeError(f"decoder init failed: {err.value.decode()}")

    @property
    def lm_order(self) -> int:
        return self._lib.ctc_decoder_lm_order(self._handle)

    def decode_batch(
        self,
        log_probs: np.ndarray,
        lens: Optional[np.ndarray] = None,
        beam_width: int = 100,
        beam_prune_logp: float = -10.0,
        token_min_logp: float = -5.0,
        n_threads: int = 0,
    ) -> List[str]:
        """log_probs (B, T, V) f32 (log-probabilities or raw logits); lens
        (B,) crops each sample's frames."""
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        b, t, v = lp.shape
        c_lens = None
        if lens is not None:
            lens_arr = np.ascontiguousarray(lens, dtype=np.int32)
            c_lens = lens_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        out = (ctypes.c_char_p * b)()
        self._lib.ctc_decoder_decode_batch(
            self._handle, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, t, v, c_lens,
            beam_width, beam_prune_logp, token_min_logp, out, n_threads,
        )
        results = [s.decode() if s is not None else "" for s in out]
        self._lib.ctc_decoder_free_strings(out, b)
        return results

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ctc_decoder_destroy(self._handle)
            self._handle = None


def log_softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max(axis=-1, keepdims=True)
    s = logits - m
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def make_lm_decoder(
    vocab: List[str],
    lm_path: Optional[str],
    beam_width: int = 100,
    beam_prune_logp: float = -10.0,
    token_min_logp: float = -5.0,
    alpha: float = 0.5,
    beta: float = 0.5,
    score_boundary: bool = False,
) -> Callable:
    """The evaluator's hook: (logits (B, T', V), logit_lens) -> list[str].

    Raw logits go into the beam search, as the reference feeds them (the
    per-frame log-softmax shift is the same for every beam, so rankings do
    not change; token_min_logp compares against raw values). Each sample is
    cropped at its logit length. A missing LM file warns and decodes
    without an LM. `decode.decoder` is the CTCBeamDecoder."""
    if lm_path is not None and not os.path.exists(lm_path):
        print(f"WARNING: LM path {lm_path!r} does not exist; decoding without LM")
        lm_path = None
    decoder = CTCBeamDecoder(vocab, lm_path=lm_path, alpha=alpha, beta=beta, score_boundary=score_boundary)

    def decode(logits: np.ndarray, logit_lens: np.ndarray) -> List[str]:
        return decoder.decode_batch(logits, logit_lens, beam_width=beam_width, beam_prune_logp=beam_prune_logp,
                                    token_min_logp=token_min_logp)

    decode.decoder = decoder
    return decode
