"""SimpleKeyfile — hex private key on disk (reference: keys/key_reader_writer.go:21)."""

from __future__ import annotations

import os

from babble_tpu_torch.crypto.keys import PrivateKey


class SimpleKeyfile:
    def __init__(self, path: str):
        self.path = path

    def read_key(self) -> PrivateKey:
        with open(self.path, "r", encoding="utf-8") as f:
            return PrivateKey.from_hex(f.read())

    def write_key(self, key: PrivateKey) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(key.hex())
