"""Voice database: cached speaker embeddings with tag metadata (counterpart
of zonos_tpu/speaker_db.py; zonos/speaker_utils.py:30-320).

A content-hash (XXH3-64, computed in numpy by ``utils/xxh3.py``) keyed
embedding cache under ``.voices/`` with a ``voices.json`` tag index,
directory averaging, tag-filtered average embeddings ("voice mixing"),
EARS-dataset scanning, tag introspection, and random test sentences.
Embeddings are stored as ``.npy`` under the same names as the JAX package's,
so either package reads a cache the other wrote; the reference's ``.pt``
files are read too.  The random-sentence corpus is built in: other languages
than English and German get an English sentence.
"""

from __future__ import annotations

import json
import os
import random
import re
from pathlib import Path

import numpy as np

from zonos_tpu_torch.utils.xxh3 import xxh3_64_hexdigest

LANGUAGE_MAP = {
    "american english": "en_us",
    "british english": "en_gb",
    "german": "de_de",
    "mandarin": "zh",
    "spanish": "es",
    "russian": "ru",
}


def normalize_language(lang: str) -> str:
    return LANGUAGE_MAP.get(lang.lower().strip(), lang)


def hash_audio_file(filepath: str) -> str:
    """XXH3-64 hex digest of the file contents (fast, non-cryptographic)."""
    return xxh3_64_hexdigest(Path(filepath).read_bytes())


_HASH_RE = re.compile(r"^[0-9a-fA-F]{16}(\.(pt|npy))?$")


class SpeakerUtils:
    """Embedding cache + voice DB around a model with make_speaker_embedding."""

    def __init__(self, model=None, embed_store_dir: str | Path = ".voices"):
        self.model = model
        self.embed_store_dir = Path(embed_store_dir)
        self.embed_store_dir.mkdir(parents=True, exist_ok=True)
        self.voices_json_path = self.embed_store_dir / "voices.json"

    # -- storage ---------------------------------------------------------
    def embedding_file_path(self, file_hash: str) -> Path:
        return self.embed_store_dir / file_hash[:1] / f"{file_hash}.npy"

    def load_embedding_if_exists(self, file_hash: str) -> np.ndarray | None:
        fpath = self.embedding_file_path(file_hash)
        if fpath.is_file():
            return np.load(fpath)
        legacy = fpath.with_suffix(".pt")  # reference-format cache
        if legacy.is_file():
            import torch

            emb = torch.load(legacy, map_location="cpu", weights_only=True)
            return np.asarray(emb.float().numpy(), np.float32)
        return None

    def save_embedding(self, file_hash: str, embedding: np.ndarray, tags: dict | None = None) -> None:
        fpath = self.embedding_file_path(file_hash)
        fpath.parent.mkdir(parents=True, exist_ok=True)
        np.save(fpath, np.asarray(embedding, np.float32))

        voices = {}
        if self.voices_json_path.is_file():
            voices = json.loads(self.voices_json_path.read_text(encoding="utf-8"))
        voices[file_hash] = tags or {}
        self.voices_json_path.write_text(json.dumps(voices, indent=2), encoding="utf-8")

    @staticmethod
    def is_audio_hash(s: str) -> bool:
        return _HASH_RE.fullmatch(s) is not None

    # -- embedding -------------------------------------------------------
    def get_speaker_embedding(self, audio_file: str, force_recalc: bool = False,
                              tags: dict | None = None) -> np.ndarray:
        """File path, directory (averaged), or bare hash -> [1, 1, 128]."""
        if self.is_audio_hash(audio_file):
            file_hash = re.sub(r"\.(pt|npy)$", "", audio_file)
        elif os.path.isdir(audio_file):
            embs = [
                self.get_speaker_embedding(os.path.join(audio_file, f), force_recalc, tags)
                for f in sorted(os.listdir(audio_file))
            ]
            return self.compute_average(embs)
        else:
            file_hash = hash_audio_file(audio_file)

        if not force_recalc:
            cached = self.load_embedding_if_exists(file_hash)
            if cached is not None:
                return cached

        from zonos_tpu_torch.audio.io import load_audio, to_mono

        wav, sr = load_audio(audio_file)
        wav = to_mono(wav)
        # pad 100 ms of trailing silence (ref: zonos/speaker_utils.py:130-133)
        wav = np.concatenate([wav, np.zeros((1, int(0.1 * sr)), np.float32)], axis=1)
        embedding = self.model.make_speaker_embedding(wav, sr)
        self.save_embedding(file_hash, embedding, tags)
        return np.asarray(embedding)

    @staticmethod
    def compute_average(embeddings: list[np.ndarray]) -> np.ndarray:
        if len(embeddings) == 1:
            return embeddings[0]
        return np.stack(embeddings, axis=0).mean(axis=0)

    # -- voice DB --------------------------------------------------------
    def scan_speaker_json(self, speaker_stats_json: str) -> None:
        """Build the DB from an EARS-style dataset layout
        (speaker_statistics.json + transcripts.json + <speaker>/<name>.wav;
        ref: zonos/speaker_utils.py:179-256)."""
        with open(speaker_stats_json, encoding="utf-8") as f:
            speaker_data = json.load(f)
        root = Path(speaker_stats_json).parent
        with open(root / "transcripts.json", encoding="utf-8") as f:
            transcripts = json.load(f)

        for speaker_id, stats in speaker_data.items():
            if "native language" in stats:
                stats["native language"] = normalize_language(stats["native language"])
            for audio_name, sentence in transcripts.items():
                tags = dict(stats)
                if m := re.search(r"emo_(.*)_sentences", audio_name):
                    tags["emotion"] = m.group(1)
                    tags["reading_style"] = "emotion"
                if m := re.search(r"(sentences|rainbow)_\d\d_(.*)", audio_name):
                    tags["reading_style"] = m.group(2)
                path = root / speaker_id / (audio_name + ".wav")
                tags.update(transcript=sentence, original_path=str(path), speaker_id=speaker_id)
                if not path.is_file():
                    print(f"warning: {path} not found, skipping")
                    continue
                print(f"processing {speaker_id}/{audio_name}")
                self.get_speaker_embedding(str(path), force_recalc=True, tags=tags)
        print(f"scan complete -> {self.voices_json_path}")

    def print_tags(self) -> None:
        if not self.voices_json_path.is_file():
            raise FileNotFoundError(f"no voices.json at {self.voices_json_path}")
        voices = json.loads(self.voices_json_path.read_text(encoding="utf-8"))
        tag_values: dict[str, set] = {}
        for tags in voices.values():
            for k, v in tags.items():
                tag_values.setdefault(k, set()).add(v)
        print("Unique tags in voices.json:")
        for k in sorted(set(tag_values) - {"original_path", "transcript"}):
            print(f" - {k}: {sorted(tag_values[k])}")

    def load_average(self, tags: dict) -> np.ndarray:
        """Average embedding over all DB entries whose tags match exactly —
        the reference's 'voice mixing' primitive (zonos/speaker_utils.py:285-320)."""
        if not self.voices_json_path.is_file():
            raise FileNotFoundError(
                f"no voices.json at {self.voices_json_path}; scan a dataset first"
            )
        voices = json.loads(self.voices_json_path.read_text(encoding="utf-8"))
        matched = []
        for file_hash, entry_tags in voices.items():
            if all(entry_tags.get(k) == v for k, v in tags.items()):
                emb = self.load_embedding_if_exists(file_hash)
                if emb is not None:
                    matched.append(emb)
        if not matched:
            raise ValueError(f"no matching embeddings for {tags} among {len(voices)} entries")
        return self.compute_average(matched)

    # -- test sentences --------------------------------------------------
    SENTENCES = {
        "en": [
            "The quick brown fox jumps over the lazy dog while the morning sun rises over the quiet valley.",
            "I can hardly believe how fast this year has gone; it feels like January was only a week ago.",
            "Please remember to water the plants, feed the cat, and lock the back door before you leave.",
            "She opened the old wooden box and found letters her grandmother had written decades earlier.",
            "If the weather holds, we should reach the summit before noon and be back by dinner.",
            "The committee will meet on Thursday to review the proposal and vote on the new budget.",
            "A gentle rain fell through the night, and by morning the whole garden smelled of earth.",
            "Learning a new language takes patience, practice, and a willingness to make mistakes.",
            "The train was delayed by twenty minutes, so we had time for a coffee at the station.",
            "Nothing compares to the sound of waves breaking on the shore at the end of a long day.",
        ],
        "de": [
            "Der schnelle braune Fuchs springt über den faulen Hund, während die Sonne aufgeht.",
            "Bitte denk daran, die Blumen zu gießen und die Tür abzuschließen, bevor du gehst.",
            "Wenn das Wetter gut bleibt, erreichen wir den Gipfel noch vor Mittag.",
            "Ich kann kaum glauben, wie schnell dieses Jahr vergangen ist.",
            "Der Zug hatte zwanzig Minuten Verspätung, also tranken wir noch einen Kaffee.",
            "Eine neue Sprache zu lernen braucht Geduld, Übung und Mut zu Fehlern.",
            "Am Abend roch der ganze Garten nach Regen und frischer Erde.",
            "Die Kinder spielten den ganzen Nachmittag am Fluss und kamen erst zum Abendessen zurück.",
        ],
    }

    @staticmethod
    def random_sentence(lang: str = "en") -> str:
        """Random test sentence from the built-in corpus (en/de); other
        languages get an English one, as the JAX package does offline
        (zonos_tpu/speaker_db.py:224-233).  Nothing is downloaded."""
        lang = lang.split("_")[0].split("-")[0]
        return random.choice(SpeakerUtils.SENTENCES.get(lang, SpeakerUtils.SENTENCES["en"]))


def main(argv: list[str] | None = None) -> None:
    """CLI: scan an EARS dataset, list tags, or query an average embedding."""
    import argparse

    ap = argparse.ArgumentParser(description="zonos-tpu voice database tool (PyTorch port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_scan = sub.add_parser("scan", help="build the DB from an EARS speaker_statistics.json")
    p_scan.add_argument("speaker_stats_json")
    p_scan.add_argument("--device", default="cuda", help="where the speaker tower runs")
    sub.add_parser("tags", help="print unique tags")
    p_avg = sub.add_parser("average", help="compute a tag-filtered average embedding")
    p_avg.add_argument("tags", help='JSON dict, e.g. \'{"gender": "female"}\'')
    p_avg.add_argument("--out", default="average.npy")
    args = ap.parse_args(argv)

    if args.cmd == "tags":
        SpeakerUtils().print_tags()
        return
    if args.cmd == "average":
        su = SpeakerUtils()
        emb = su.load_average(json.loads(args.tags))
        np.save(args.out, emb)
        print(f"saved average embedding {emb.shape} -> {args.out}")
        return
    if args.cmd == "scan":
        SpeakerUtils(_Embedder(args.device)).scan_speaker_json(args.speaker_stats_json)


class _Embedder:
    """``make_speaker_embedding`` without a TTS model: the scan needs only
    the speaker tower (``Zonos.make_speaker_embedding`` computes the same)."""

    def __init__(self, device: str):
        from zonos_tpu_torch.models.speaker import SpeakerEmbeddingLDA

        self.tower = SpeakerEmbeddingLDA(device=device)

    def make_speaker_embedding(self, wav: np.ndarray, sr: int) -> np.ndarray:
        return np.asarray(self.tower(wav, sr)[1], np.float32).reshape(1, 1, -1)


if __name__ == "__main__":
    main()
