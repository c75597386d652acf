"""The viewer's command channel on a mesh of ranks: rank 0 answers HTTP, and
every rank runs rank 0's commands in one order.

The port runs one process a card, and NCCL and gloo need every rank to
issue the same collectives in the same order. So on a `DataMesh` of W > 1
ranks the viewer's state changes (`/params`, `/nudge`, `/drag`, `/train`)
and its collective work (`/preview`, `/generate`) are commands: rank 0's
HTTP handler threads queue them (`submit`, `call`), and on every rank one
thread, the only one there that issues collectives, takes rank 0's next
control word by an object broadcast and runs its commands (`serve_once`).
After each command the ranks gather whether it raised, so that an error on
any rank reaches the client and leaves no rank waiting.

A control word holds the commands queued since the last one, up to and
including the first that ends a word (`/generate`, which runs until its
refinement is done and serves the words queued meanwhile from inside the
train loop); an empty word is one broadcast integer. Between train calls
the trainer hands out one word
(`follow`), so that a pause lands at the same step on every rank, and
while paused it keeps serving words.

An idle viewer may wait hours for a click, but a collective that waits
longer than the group's timeout fails: rank 0 hands out an empty word
every `heartbeat_s` (a quarter of the timeout) while nothing is queued.
The words travel over the mesh's host group (gloo), so they never wait on
a card's stream.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

Command = Tuple[str, tuple, Dict[str, Any]]


class ChannelClosed(Exception):
    """Raised on every rank at the word that closes the channel."""


class CommandChannel:
    def __init__(self, mesh: "DataMesh", run: Callable[[str, tuple, Dict[str, Any]], Any],
                 ends_word: Tuple[str, ...] = ()):
        """`run(name, args, kwargs)` runs a command on this rank and returns
        its result (rank 0's goes to the caller). `ends_word`: the names of
        the commands after which a word takes no more."""
        self.mesh = mesh
        self.run = run
        self.ends_word = ends_word
        self.heartbeat_s = mesh.timeout_s / 4
        self.group = mesh.host_group()
        self.words = 0  # control words handed out (rank 0) or received
        self.word_s: List[float] = []  # each word's broadcast, in seconds, while training (`follow`)
        self._queue: "queue.Queue[Optional[Tuple[Command, Future]]]" = queue.Queue()  # rank 0's
        self._open: List[Future] = []  # rank 0: futures handed out and not yet resolved
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # rank 0's HTTP handler threads
    # ------------------------------------------------------------------

    def submit(self, name: str, *args, **kwargs) -> Future:
        """Queue a command; its future resolves once every rank has run it."""
        fut: Future = Future()
        with self._lock:
            self._open.append(fut)
        self._queue.put(((name, args, kwargs), fut))
        return fut

    def call(self, name: str, *args, **kwargs) -> Any:
        """Run a command on every rank; rank 0's result, or its error (an
        error on another rank only: RuntimeError naming the rank)."""
        return self.submit(name, *args, **kwargs).result()

    def close(self) -> None:
        """Every rank leaves `serve` after the commands queued before this."""
        self._queue.put(None)

    # ------------------------------------------------------------------
    # every rank's one issuing thread
    # ------------------------------------------------------------------

    def _take(self, block: bool) -> Tuple[List[Command], List[Future], bool]:
        """Rank 0: the queued commands of the next word (waiting up to a
        heartbeat for the first when `block`), their futures, and whether
        the channel closes after them."""
        commands: List[Command] = []
        futures: List[Future] = []
        try:
            item = self._queue.get(timeout=self.heartbeat_s) if block else self._queue.get_nowait()
            while True:
                if item is None:
                    return commands, futures, True
                commands.append(item[0])
                futures.append(item[1])
                if item[0][0] in self.ends_word:
                    break
                item = self._queue.get_nowait()
        except queue.Empty:
            pass
        return commands, futures, False

    def serve_once(self, block: bool) -> None:
        """Take rank 0's next control word (rank 0 waiting up to a heartbeat
        for a command when `block`) and run its commands; raise
        ChannelClosed if it closes the channel."""
        mesh = self.mesh
        commands, futures, closed = self._take(block) if mesh.is_main else ([], [], False)
        t0 = time.perf_counter()
        # An empty word, every train call's usual one, is a single integer.
        if mesh.broadcast_flag(bool(commands) or closed, group=self.group):
            commands, closed = mesh.broadcast_object((commands, closed) if mesh.is_main else None, group=self.group)
        if not block:
            self.word_s.append(time.perf_counter() - t0)
        self.words += 1
        for i, (name, args, kwargs) in enumerate(commands):
            try:
                result, error = self.run(name, args, kwargs), None
            except ChannelClosed:
                raise
            except Exception as exc:  # noqa: BLE001 - every error goes to the client
                result, error = None, exc
            said = mesh.gather_objects(None if error is None else f"{type(error).__name__}: {error}",
                                       group=self.group)
            if mesh.is_main:
                others = [(r, s) for r, s in enumerate(said) if s is not None and r != 0]
                if error is not None:
                    futures[i].set_exception(error)
                elif others:
                    futures[i].set_exception(RuntimeError(f"{name} failed on rank {others[0][0]}: {others[0][1]}"))
                else:
                    futures[i].set_result(result)
                with self._lock:
                    self._open.remove(futures[i])
        if closed:
            raise ChannelClosed()

    def serve(self) -> None:
        """Serve words until the channel closes (the dispatcher's loop)."""
        try:
            while True:
                self.serve_once(block=True)
        except ChannelClosed:
            pass
        finally:
            with self._lock:
                for fut in self._open:
                    if not fut.done():
                        fut.set_exception(ChannelClosed("the viewer's channel closed"))
                self._open.clear()

    def follow(self, trainer) -> None:
        """Between two train calls: one word, then more while the trainer
        is paused."""
        self.serve_once(block=False)
        while trainer.training_state == "paused":
            self.serve_once(block=True)
