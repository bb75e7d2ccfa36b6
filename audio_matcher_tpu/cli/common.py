"""Shared CLI infrastructure: logger levels + interactive prompts.

Parity: the reference's ``common::args::debug::OutputLevel`` (``--verbose`` /
``--silent`` clap group initializing the ``log`` backend) and
``common::args::input::Inputs`` (consent prompts ``ask_consent``, generic
``read``/``try_read`` with defaults, autocompleting ``read_with_suggestion``);
see SURVEY.md §2.15.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

LOG = logging.getLogger("audio_matcher")


def add_output_level_args(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="more logging (-v debug, -vv trace)",
    )
    g.add_argument("--silent", action="store_true", help="only errors")


def init_logger(args: argparse.Namespace) -> None:
    if getattr(args, "silent", False):
        level = logging.ERROR
    elif getattr(args, "verbose", 0) >= 2:
        level = 5  # trace
    elif getattr(args, "verbose", 0) == 1:
        level = logging.DEBUG
    else:
        level = logging.INFO
    logging.addLevelName(5, "TRACE")
    logging.basicConfig(
        level=level, format="[%(levelname)s %(name)s] %(message)s", stream=sys.stderr,
        force=True,
    )


def trace(logger: logging.Logger, msg: str, *a) -> None:
    logger.log(5, msg, *a)


def add_inputs_args(p: argparse.ArgumentParser) -> None:
    """The reference's ``Inputs`` "always answer" group (-y / -n)."""
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "-y", "--yes", action="store_true", help="answer all consent prompts with yes"
    )
    g.add_argument(
        "-n", "--no", action="store_true", help="answer all consent prompts with no"
    )


class Inputs:
    """Interactive prompt helper with an optional forced answer.

    ``always=True`` / ``always=False`` mirror the -y / -n flags; ``None``
    actually prompts on stdin. ``script`` queues canned responses so the
    worker's interactive flows can be driven from tests (the fake-pipe
    strategy the reference lacked).
    """

    def __init__(self, always: Optional[bool] = None, script=None):
        self.always = always
        self.script = list(script) if script is not None else None

    def _next_scripted(self) -> Optional[str]:
        if self.script is None:
            return None
        if not self.script:
            raise EOFError("scripted input exhausted")
        return self.script.pop(0)

    def _input(self, prompt: str) -> str:
        scripted = self._next_scripted()
        if scripted is not None:
            return scripted
        return input(prompt)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Inputs":
        if getattr(args, "yes", False):
            return cls(True)
        if getattr(args, "no", False):
            return cls(False)
        return cls(None)

    def ask_consent(self, msg: str) -> bool:
        if self.always is not None:
            return self.always
        while True:
            ans = self._input(f"{msg} [y/n]: ").strip().lower()
            if ans in ("y", "yes", "j", "ja"):
                return True
            if ans in ("n", "no", "nein"):
                return False

    def read(self, msg: str, default: Optional[str] = None) -> str:
        prompt = msg if msg.endswith((" ", ":")) else msg + " "
        if default is not None:
            prompt += f"[{default}] "
        line = self._input(prompt)
        if not line and default is not None:
            return default
        return line

    def try_read(
        self,
        msg: str,
        default: Optional[T],
        parse: Callable[[str], Optional[T]],
    ) -> Optional[T]:
        """Prompt until ``parse`` succeeds; empty input returns ``default``."""
        while True:
            line = self._input(msg if msg.endswith((" ", ":")) else msg + " ")
            if not line:
                return default
            val = parse(line)
            if val is not None:
                return val

    def map_read(
        self,
        msg: str,
        default,
        _suggestion,
        mapper: Callable[[str], Optional[T]],
    ) -> Optional[T]:
        while True:
            try:
                line = self._input(msg)
            except EOFError:
                return default
            val = mapper(line)
            if val is not None:
                return val

    def read_with_suggestion(
        self, msg: str, initial: Optional[str], completer
    ) -> str:
        if self.script is not None:
            # mirror the interactive fallback's empty-input-means-initial
            # semantics so scripted tests exercise production behavior
            return self._input(msg) or (initial or "")
        return self._read_with_readline(msg, initial, completer)

    @staticmethod
    def _read_with_readline(msg: str, initial: Optional[str], completer) -> str:
        """Prompt with autocompletion. ``completer`` must provide
        ``get_suggestions(input) -> list[str]``. Uses readline when on a tty,
        otherwise a plain prompt (suggestions shown on demand with '?')."""
        try:
            import readline  # noqa: F401

            def rl_complete(text, state):
                try:
                    sugg = completer.get_suggestions(text)
                except Exception:
                    sugg = []
                return sugg[state] if state < len(sugg) else None

            readline.set_completer(rl_complete)
            readline.parse_and_bind("tab: complete")
            try:
                if initial:
                    readline.set_startup_hook(lambda: readline.insert_text(initial))
                return input(msg if msg.endswith(" ") else msg + " ")
            finally:
                readline.set_startup_hook(None)
                readline.set_completer(None)
        except ImportError:
            prompt = msg if msg.endswith(" ") else msg + " "
            if initial:
                prompt += f"[{initial}] "
            line = input(prompt)
            return line or (initial or "")
