"""The port's CLIP prompt encoding (threestudio_3dgs_tpu_torch.guidance.
tokenizer, .clip and the PromptUtils that calls them) against
``transformers`` and the JAX package on the CPU.

A tiny tokenizer directory (the 256 byte symbols, their ``</w>`` forms, the
merges learned from a few lines of text, the two special tokens) is written
by the port's ``write_tokenizer``; ``transformers.CLIPTokenizer`` (without
ftfy, as here and in the JAX package's environment) must give the same ids.
Tiny random ``CLIPTextModel``s saved by ``transformers`` (``.safetensors``
and ``.bin``, ``gelu`` and ``quick_gelu``) must encode to the JAX package's
``_clip_encode_local`` within 1e-5; likewise the image tower
(``CLIPVisionModelWithProjection``, the Zero123 guidance's) against
``transformers`` and the JAX package's ``_clip_image_encode_local``."""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

transformers = pytest.importorskip("transformers")

from threestudio_3dgs_tpu.guidance import base as jbase  # noqa: E402
from threestudio_3dgs_tpu.guidance import temporal_zero123 as jz123  # noqa: E402

from threestudio_3dgs_tpu_torch.guidance import clip as pclip  # noqa: E402
from threestudio_3dgs_tpu_torch.guidance import temporal_zero123 as pz123  # noqa: E402
from threestudio_3dgs_tpu_torch.guidance.base import (  # noqa: E402
    VIEW_SUFFIXES, PromptProcessor, PromptUtils, text_embedding)
from threestudio_3dgs_tpu_torch.guidance.tokenizer import (  # noqa: E402
    CLIPTokenizer, write_tokenizer)

CORPUS = (
    "a hamburger, a photo of a delicious hamburger on a plate. a DSLR photo of a cat's hat; "
    "it'll be the dog's café at 3 o'clock! résumé naïve 2024 100% front view side view back "
    "view overhead view, a zoomed out photo of a pineapple wearing sunglasses"
)
PROMPTS = {
    "plain": "a hamburger",
    "accents": "a Café's résumé, naïve crème brûlée",
    "digits": "it'll be 2024 o'clock; you're 42nd in 3.14159",
    "apostrophes": "the dog's bone, we'll see, they've gone, I'm here, he'd go, don't",
    "punctuation": "wow!! so... (cool) -- [yes] {no} #1 @home $5 a/b \"q\"",
    "upper": "A DSLR PHOTO OF A HAMBURGER",
    "whitespace": "tab\tand\nnewline   spaces nbsp",
    "cjk_emoji": "中文 mixed 漢字 and 🍔 burger",
    "long": " ".join(["delicious hamburger"] * 60),
    "special_inside": "before <|endoftext|> after",
    "front": "a hamburger" + VIEW_SUFFIXES[0],
    "side": "a hamburger" + VIEW_SUFFIXES[1],
    "back": "a hamburger" + VIEW_SUFFIXES[2],
    "overhead": "a hamburger" + VIEW_SUFFIXES[3],
}
PADS = {"eos_pad": "<|endoftext|>", "bang_pad": "!"}  # SD 2.x directories pad with "!"


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_tok")
    out = {}
    for name, pad in PADS.items():
        write_tokenizer(str(root / name), CORPUS, 300, pad_token=pad)
        out[name] = str(root / name)
    return out


@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_tokenizer_matches_transformers(tokenizer_dirs, pad, prompt):
    """Exact ids, padded to 77 (truncated with EOS kept for the long
    prompt), as the JAX package calls the tokenizer."""
    directory = tokenizer_dirs[pad]
    want = transformers.CLIPTokenizer.from_pretrained(directory)(
        PROMPTS[prompt], padding="max_length", max_length=77, truncation=True).input_ids
    got = CLIPTokenizer(directory)(PROMPTS[prompt])
    assert got == want
    assert len(got) == 77


def test_tokenizer_merges_and_truncation(tokenizer_dirs):
    """The learned merges are read and used (fewer ids than UTF-8 bytes;
    the corpus runs out of pairs before 300), the long prompt fills all 77
    positions and ends in EOS, and the "!" directory pads with the id of
    "!"."""
    tok = CLIPTokenizer(tokenizer_dirs["bang_pad"])
    with open(os.path.join(tokenizer_dirs["bang_pad"], "merges.txt")) as f:
        n_merges = len(f.read().strip().split("\n")) - 1
    assert len(tok.bpe_ranks) == n_merges > 50
    text = "a delicious hamburger"
    assert len(tok.tokenize(text)) < len(text.replace(" ", ""))
    ids = tok(PROMPTS["long"])
    assert ids[-1] == tok.encoder["<|endoftext|>"] and tok.encoder["!"] not in ids
    short = tok("a hamburger")
    assert short[-1] == tok.encoder["!"]


TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=77)


def write_clip_dir(root, tokenizer_dir, act, safe):
    """``root/tokenizer`` (a copy of the tiny tokenizer) and
    ``root/text_encoder`` (a seeded random transformers CLIPTextModel)."""
    os.makedirs(root / "tokenizer")
    for name in os.listdir(tokenizer_dir):
        with open(os.path.join(tokenizer_dir, name), "rb") as f:
            (root / "tokenizer" / name).write_bytes(f.read())
    with open(os.path.join(tokenizer_dir, "vocab.json")) as f:
        vocab = len(json.load(f))
    torch.manual_seed(0)
    model = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=vocab, hidden_act=act, **TINY_TEXT))
    model.save_pretrained(str(root / "text_encoder"), safe_serialization=safe)
    return str(root)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_clip_encoder_matches_jax(tokenizer_dirs, tmp_path, act, safe):
    """The port's hand-written encoder on the JAX package's tokenizer and
    transformers encoder: (77, 32) hidden states within 1e-5."""
    root = write_clip_dir(tmp_path, tokenizer_dirs["bang_pad"], act, safe)
    weights = "model.safetensors" if safe else "pytorch_model.bin"
    assert os.path.exists(os.path.join(root, "text_encoder", weights))
    encoder = pclip.PromptEncoder(root)
    for prompt in ("a hamburger", PROMPTS["accents"], PROMPTS["long"]):
        want = jbase._clip_encode_local(root, prompt)
        assert want is not None, "the JAX package fell back"
        got = encoder(prompt)
        assert got.shape == (77, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_prompt_utils_match_jax(tokenizer_dirs, tmp_path):
    """PromptUtils of both packages on one directory: the prompt's and the
    four view variants' embeddings within 1e-5, and the view pick."""
    root = write_clip_dir(tmp_path, tokenizer_dirs["eos_pad"], "gelu", True)
    want = jbase.PromptUtils("a hamburger", model_dir=root)
    got = PromptProcessor({"prompt": "a hamburger", "pretrained_model_name_or_path": root},
                          device="cpu")()
    assert got.text_embedding.shape == (77, 32) and got.view_embeddings.shape == (4, 77, 32)
    np.testing.assert_allclose(got.text_embedding, np.asarray(want.text_embedding), atol=1e-5)
    np.testing.assert_allclose(got.view_embeddings, np.asarray(want.view_embeddings), atol=1e-5)
    elev, azim = np.array([0.0, 10.0, 80.0]), np.array([0.0, 180.0, 90.0])
    np.testing.assert_allclose(got.get_text_embeddings(elev, azim),
                               np.asarray(want.get_text_embeddings(elev, azim)), atol=1e-5)


def test_prompt_utils_fall_back_without_clip_dirs(tmp_path):
    """No text_encoder/ + tokenizer/ (no directory, or only one of the
    two): the CRC32-seeded vectors, as before."""
    (tmp_path / "tokenizer").mkdir()
    for model_dir in ("", "no/such/dir", str(tmp_path)):
        pu = PromptUtils("a hamburger", model_dir=model_dir, device="cpu")
        np.testing.assert_array_equal(pu.text_embedding, text_embedding("a hamburger"))


def test_broken_clip_dir_raises(tokenizer_dirs, tmp_path):
    """A directory with both subdirectories but no weights: the JAX package
    falls back to its hash vectors in silence; the port raises."""
    root = write_clip_dir(tmp_path, tokenizer_dirs["eos_pad"], "gelu", True)
    os.remove(os.path.join(root, "text_encoder", "model.safetensors"))
    assert jbase._clip_encode_local(root, "a hamburger") is None
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        PromptUtils("a hamburger", model_dir=root, device="cpu")


def test_read_safetensors_matches_package(tmp_path):
    """The port's reader of the format against the safetensors package,
    over the types a checkpoint holds (and an empty tensor)."""
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=gen),
        "f16": torch.randn((7,), generator=gen).half(),
        "bf16": torch.randn((2, 2, 3), generator=gen).bfloat16(),
        "i64": torch.arange(11, dtype=torch.int64),
        "u8": torch.arange(5, dtype=torch.uint8),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = pclip.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_write_random_text_encoder_loads(tmp_path):
    """The seeded random directory the smoke run writes loads strictly into
    the encoder and into transformers' CLIPTextModel alike."""
    cfg = pclip.CLIPTextConfig(vocab_size=600, hidden_act="gelu", **TINY_TEXT)
    nbytes = pclip.write_random_text_encoder(str(tmp_path / "te"), cfg, seed=1)
    assert nbytes > 0
    ours = pclip.load_text_encoder(str(tmp_path / "te"), "cpu")
    theirs = transformers.CLIPTextModel.from_pretrained(str(tmp_path / "te")).eval()
    ids = torch.tensor([[598, 3, 17, 5, 599] + [599] * 72])
    with torch.no_grad():
        np.testing.assert_allclose(ours(ids).numpy(), theirs(ids)[0].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The image tower (the Zero123 guidance's CLIP image embeddings)
# ---------------------------------------------------------------------------

TINY_VISION = dict(hidden_size=32, intermediate_size=64, projection_dim=24,
                   num_hidden_layers=2, num_attention_heads=4, image_size=16, patch_size=4)


def frames(n=2, size=40, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("writer", ["port_bin", "transformers_safetensors"])
def test_clip_image_tower_matches_transformers_and_jax(tmp_path, writer):
    """The port's image tower on 40^2 frames (resized to 16^2, antialiased,
    then CLIP-normalised), its weights written by the port (``.bin``) or
    by ``transformers`` (``model.safetensors``, quick_gelu): against
    ``CLIPVisionModelWithProjection`` on the JAX package's resized input
    and against the JAX package's ``_clip_image_encode_local``, both to
    1e-5."""
    import jax
    import jax.numpy as jnp

    directory = str(tmp_path / "image_encoder")
    if writer == "port_bin":
        pclip.write_random_image_encoder(directory, pclip.CLIPVisionConfig(**TINY_VISION), seed=4)
        model = transformers.CLIPVisionModelWithProjection.from_pretrained(directory)
    else:
        torch.manual_seed(4)
        model = transformers.CLIPVisionModelWithProjection(
            transformers.CLIPVisionConfig(**TINY_VISION, hidden_act="quick_gelu"))
        model.save_pretrained(directory, safe_serialization=True)
        assert os.path.exists(os.path.join(directory, "model.safetensors"))
    x = frames()
    got = pclip.ImageEncoder(directory)(x)
    want = jz123._clip_image_encode_local(directory, x)
    assert got.shape == want.shape == (2, TINY_VISION["projection_dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    resized = np.asarray(jax.image.resize(jnp.asarray(x), (2, 16, 16, 3), "bilinear"))
    mean, std = np.array(pclip.CLIP_MEAN, np.float32), np.array(pclip.CLIP_STD, np.float32)
    with torch.no_grad():
        ref = model(torch.tensor(((resized - mean) / std).transpose(0, 3, 1, 2))).image_embeds
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-5)


def test_clip_image_tower_that_does_not_load_raises(tmp_path):
    """An image_encoder/ whose weights do not fit its config (a projection
    width the weights do not have): the JAX package falls back (None), the
    port raises (a deliberate difference); an absent directory is None in
    both."""
    bad = tmp_path / "image_encoder"
    pclip.write_random_image_encoder(str(bad), pclip.CLIPVisionConfig(**TINY_VISION), seed=4)
    cfg = json.loads((bad / "config.json").read_text())
    (bad / "config.json").write_text(json.dumps(dict(cfg, projection_dim=32)))
    assert jz123._clip_image_encode_local(str(bad), frames()) is None
    assert jz123._clip_image_encode_local(str(tmp_path / "absent"), frames()) is None
    with pytest.raises(RuntimeError, match="visual_projection"):
        pz123._clip_image_embeddings(str(bad), frames(), "cpu")
    assert pz123._clip_image_embeddings(str(tmp_path / "absent"), frames(), "cpu") is None
