"""audio_matcher_tpu — a GPU-accelerated audio alignment framework in JAX.

Re-implements the full capability surface of the reference ``audio-matcher``
Rust CLI suite (FFT snippet matching, Audacity-driven episode cutting,
series-index/archive bookkeeping, mp3/opus tagging), redesigned for an
accelerator: the compute core is batched overlap-save FFT
cross-correlation with on-device peak picking (JAX/XLA/Pallas), batched
over many (episode, snippet) pairs and sharded over a device mesh via
``jax.sharding``.

Layer map (mirrors SURVEY.md §1):
  L0 hostio.decode     — mp3/opus/wav → f32 mono PCM (C++ frontend + fallback)
  L1 meta.tagger       — ID3v2 / Ogg-Opus VorbisComment tags
  L2 ops.*             — the device compute core (correlate + peaks)
  L3 models.matcher    — the matcher pipeline (calc_chunks equivalent)
  L4 worker.*          — interactive Audacity episode pipeline
  L5 archive.*         — archive model + label-name grammar
  L6 utils.* / cli.*   — config, durations, prompts, logging
  L7 cli.*_cli         — audio-matcher / audio-worker / archive-scroller
"""

APP_NAME = "audio-matcher"  # config dir name; parity: reference src/lib.rs:6

__version__ = "0.1.0"


def match(snippet, episode, sr, **config_kwargs):
    """One-call library API: find ``snippet`` inside ``episode``.

    Returns the deduped :class:`~audio_matcher_tpu.ops.peaks.Peak` list
    (positions in samples). Keyword args go to
    :class:`~audio_matcher_tpu.models.matcher.MatchConfig`.
    """
    from .models.matcher import MatchConfig, SnippetMatcher

    return SnippetMatcher(snippet, sr, MatchConfig(**config_kwargs)).match(
        episode
    )


def offset_range(rng, offset):
    """Shift a (start, end) index range by ``offset`` samples.

    Parity: reference src/lib.rs:8-10 (``offset_range``).
    """
    return (rng[0] + offset, rng[1] + offset)
