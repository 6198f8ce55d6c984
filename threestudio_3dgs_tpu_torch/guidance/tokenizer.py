"""The CLIP byte-level BPE tokenizer, read from a local ``tokenizer/``
directory (``vocab.json``, ``merges.txt`` and the special tokens of
``special_tokens_map.json`` / ``tokenizer_config.json``).

It gives the ids ``transformers.CLIPTokenizer`` gives when ``ftfy`` is not
installed, the tokenizer the JAX package calls with ``padding="max_length",
max_length=77, truncation=True``:

  * the text is split at every special token (BOS, EOS, UNK, pad), each of
    which maps to its own id;
  * each other piece is cleaned (control characters dropped, whitespace to
    spaces), NFC-normalised, lower-cased and split on whitespace, as
    ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)`` does;
  * CLIP's pattern splits the words: the contractions 's 't 're 've 'm 'll
    'd, runs of letters, single digits and runs of anything else.  The
    ``regex`` package's ``\\p{L}`` / ``\\p{N}`` classes are read from
    ``unicodedata`` categories (L*, N*), so only ``re``-free stdlib is used;
  * each piece's UTF-8 bytes go through the byte-to-unicode table and BPE;
  * BOS + ids + EOS, the ids cut to ``max_length - 2`` (EOS is kept), then
    padded with the pad token's id to ``max_length``.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from collections import Counter
from typing import Dict, List, Tuple

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
MAX_MERGES = 49152 - 256 - 2  # merges.txt lines CLIP reads after its header
CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
              (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 / CLIP's reversible byte -> printable unicode character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in CJK_RANGES)


def basic_clean(text: str) -> str:
    """What the tokenizer does to the text before its pattern when ftfy is
    absent: drop NUL, U+FFFD and control characters, whitespace to spaces,
    spaces around CJK ideographs, NFC, split on whitespace, lower-case,
    re-join with single spaces."""
    chars = []
    for ch in text:
        if ch in ("\x00", "\ufffd") or _is_control(ch):
            continue
        if _is_whitespace(ch):
            chars.append(" ")
        elif _is_cjk(ch):
            chars += [" ", ch, " "]
        else:
            chars.append(ch)
    words = unicodedata.normalize("NFC", "".join(chars)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def pattern_split(text: str) -> List[str]:
    """CLIP's ``re.findall`` with its pattern ``<|startoftext|>|<|endoftext|>
    |'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` on
    lower-case text (where its case-insensitive flag changes nothing)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        special = next((s for s in (BOS, EOS) if text.startswith(s, i)), None)
        if special is None:
            special = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
        if special is not None:
            out.append(text[i:i + len(special)])
            i += len(special)
            continue
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif not _is_number(ch):
            while j < n and not (text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _token_content(value) -> str:
    """A special token of a tokenizer JSON file: a string or an AddedToken
    dict with "content"."""
    return value["content"] if isinstance(value, dict) else str(value)


class CLIPTokenizer:
    """``CLIPTokenizer(directory)(text)`` -> a list of ``max_length`` ids."""

    def __init__(self, directory: str, max_length: int = 77):
        self.max_length = max_length
        with open(os.path.join(directory, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(directory, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks: Dict[Tuple[str, ...], int] = {
            tuple(line.split()): i for i, line in enumerate(lines)}
        special = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": EOS}
        # tokenizer_config.json first, special_tokens_map.json over it
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(directory, name)
            if os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                for key in special:
                    if data.get(key) is not None:
                        special[key] = _token_content(data[key])
        missing = [tok for tok in special.values() if tok not in self.encoder]
        if missing:
            raise ValueError(f"{directory}: special tokens {missing} are not in vocab.json")
        self.special = special
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {BOS: BOS, EOS: EOS}

    def bpe(self, token: str) -> List[str]:
        """BPE of one pattern piece (already byte-encoded), lowest rank
        first; the last symbol carries the end-of-word mark."""
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return list(word)

    def _split_special(self, text: str) -> List[str]:
        """The text cut at every occurrence of a special token (longest
        first at a position); the tokens are pieces of their own."""
        tokens = sorted(set(self.special.values()), key=len, reverse=True)
        pieces, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in tokens if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i += len(hit)
            start = i
        pieces.append(text[start:])
        return [p for p in pieces if p]

    def tokenize(self, text: str) -> List[int]:
        """The ids of the text without BOS, EOS, truncation or padding."""
        specials = set(self.special.values())
        unk = self.encoder[self.special["unk_token"]]
        ids = []
        for piece in self._split_special(text):
            if piece in specials:
                ids.append(self.encoder[piece])
                continue
            for word in pattern_split(basic_clean(piece)):
                encoded = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                ids += [self.encoder.get(tok, unk) for tok in self.bpe(encoded)]
        return ids

    def __call__(self, text: str) -> List[int]:
        bos, eos, pad = (self.encoder[self.special[k]] for k in ("bos_token", "eos_token",
                                                                  "pad_token"))
        ids = [bos] + self.tokenize(text)[: self.max_length - 2] + [eos]
        return ids + [pad] * (self.max_length - len(ids))


def write_tokenizer(directory: str, corpus: str, n_merges: int, pad_token: str = EOS) -> None:
    """A small CLIP tokenizer directory: the 256 byte symbols and their
    ``</w>`` forms, then ``n_merges`` merges learned from ``corpus`` (the
    most frequent adjacent pair of its words' symbols, ties to the smaller
    pair), then BOS and EOS; ``pad_token`` in ``special_tokens_map.json``."""
    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    byte_encoder = bytes_to_unicode()
    words = Counter()
    for word in pattern_split(basic_clean(corpus)):
        encoded = "".join(byte_encoder[b] for b in word.encode("utf-8"))
        words[tuple(encoded[:-1]) + (encoded[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for word, count in words.items():
            for pair in zip(word[:-1], word[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged = Counter()
        for word, count in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += count
        words = merged
    vocab += [BOS, EOS]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(dict.fromkeys(vocab))}, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(directory, "special_tokens_map.json"), "w", encoding="utf-8") as f:
        json.dump({"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": pad_token}, f)
