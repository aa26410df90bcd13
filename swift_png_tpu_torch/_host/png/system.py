"""File-backed bytestreams (a copy of ``swift_png_tpu/png/system.py``;
``System.File.Source`` and ``System.File.Destination``,
``System.swift:27-316``)."""

from __future__ import annotations

from .chunk import ByteDestination, ByteSource


class FileSource(ByteSource):
    """A PNG read whole from a file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            super().__init__(f.read())
        self.path = path

    @property
    def count(self) -> int:
        return len(self.data)


class FileDestination(ByteDestination):
    """A PNG written to a file on :meth:`close`."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def close(self) -> None:
        with open(self.path, "wb") as f:
            f.write(self.getvalue())
