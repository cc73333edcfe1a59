"""What the single-device ``Spectroscopy`` objects on one database reuse
across requests: the built stacked lines pipelines over its packs
(:class:`StackedPipelines`) and the pinned host buffers their outputs
come back through (:class:`HostStaging`), held together by one
:class:`Reuse` per database (:func:`reuse_of`) that dies with it.
"""
import contextlib
import math
import threading
import weakref
from collections import OrderedDict

import torch

# Built stacked lines pipelines kept for the Spectroscopy objects over one
# database's packs, the least recently used evicted first.  An entry
# holds 81 MB of the card for a 60-layer column of 420k lines at 0.1 cm-1
# and 174 MB at 0.01 cm-1 (H100), so four stay under 0.7 GB beside the
# 13 GB such a column at 0.01 cm-1 peaks at.
STACKED_KEPT = 4


class StackedPipelines:
    """The stacked lines pipelines built over one database's packs,
    shared by every single-device ``Spectroscopy`` on it: at most
    ``STACKED_KEPT`` entries, the least recently used evicted first.

    An entry keeps the packs it was built from, so the pack ``id``s in its
    key (a re-read or re-ingested pack is another object, and misses) are
    not reused while it lives.  Objects in several threads may share it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = OrderedDict()

    def __len__(self):
        return len(self._entries)

    def get(self, key):
        """The entry under ``key`` (now the most recently used), or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[1]

    def put(self, key, packs, built):
        """Keeps ``built``, made from ``packs``, under ``key``."""
        with self._lock:
            self._entries[key] = (tuple(packs), built)
            self._entries.move_to_end(key)
            while len(self._entries) > STACKED_KEPT:
                self._entries.popitem(last=False)


class HostStaging:
    """Pinned host buffers into which ``Spectroscopy.compute_absorption``
    copies its blocks back from the card, kept across calls so that a
    request allocates none.

    A call leases a set of buffers of its own (:meth:`lease`; a call in
    another thread takes another set) with its copy stream; a buffer grows
    to the largest block it has held.
    """

    class Buffers:
        """One lease's pinned buffers by key, and its copy stream on each
        device."""

        def __init__(self):
            self._buffers = {}
            self._streams = {}

        def get(self, key, shape, dtype):
            """A pinned host tensor of ``shape`` and ``dtype``: a view of
            the buffer under ``key``, reallocated where it is too small or
            of another dtype."""
            numel = math.prod(shape)
            buffer = self._buffers.get(key)
            if buffer is None or buffer.dtype != dtype \
                    or buffer.numel() < numel:
                buffer = self._buffers[key] = torch.empty(
                    numel, dtype=dtype, pin_memory=True)
            return buffer[:numel].view(shape)

        def stream(self, device):
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
            return stream

    def __init__(self):
        self._lock = threading.Lock()
        self._free = []

    @contextlib.contextmanager
    def lease(self):
        """Yields a :class:`Buffers` that no other lease holds until this
        one ends.  A copy it started lands before a later lease's copies
        into it (one stream orders them)."""
        with self._lock:
            buffers = self._free.pop() if self._free else self.Buffers()
        try:
            yield buffers
        finally:
            with self._lock:
                self._free.append(buffers)


class Reuse:
    """What the single-device ``Spectroscopy`` objects on one database
    share: ``pipelines``, the :class:`StackedPipelines` built over its
    packs, and ``staging``, the :class:`HostStaging` they copy their
    results back through."""

    def __init__(self):
        self.pipelines = StackedPipelines()
        self.staging = HostStaging()


_lock = threading.Lock()
_by_database = weakref.WeakKeyDictionary()


def reuse_of(database):
    """The :class:`Reuse` of ``database``, made on its first request and
    dropped with the database; a fresh, unshared one for an object that
    cannot be weakly referenced or hashed."""
    try:
        with _lock:
            reuse = _by_database.get(database)
            if reuse is None:
                reuse = _by_database[database] = Reuse()
            return reuse
    except TypeError:
        return Reuse()
