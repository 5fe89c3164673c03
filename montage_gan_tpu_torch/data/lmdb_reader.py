"""Pure-Python read-only LMDB walker.

A copy of ``montage_gan_tpu/data/lmdb_reader.py`` (lines 40-224 verbatim):
the port keeps its own, as it imports nothing of the JAX package.  The
reference's dataset_tool ingests LSUN archives through the ``lmdb`` package
(reference: montage_gan/dataset_tool.py:118-142 — open env, iterate the
main DB's cursor in key order, decode each value as an image); this module
reads the LMDB file format directly, without it: an LMDB environment is a
memory-mapped copy-on-write B+tree (OpenLDAP liblmdb, mdb.c), and a
read-only full scan needs only

  * the two meta pages (double-buffered roots; the live one has the larger
    transaction id),
  * branch/leaf page traversal in key order,
  * overflow-page reassembly for values larger than a page.

Scope: plain databases (the main DB of an LSUN archive).  ``MDB_DUPSORT``
sub-databases and ``MDB_DUPFIXED`` (LEAF2) pages are detected and rejected
with a clear error — dataset archives do not use them.  Only the little-
endian 64-bit file layout is supported (the format LSUN ships).

Layout facts encoded below (from lmdb's mdb.c, stated here so the constants
are auditable):

  page header (16 bytes): pgno u64 | pad u16 | flags u16 | lower u16 ·
      upper u16 (for overflow pages the last 4 bytes are instead the u32
      page count)
  page flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08 LEAF2=0x20
  node (at each u16 ptr after the header, offsets page-relative):
      lo u16 | hi u16 | flags u16 | ksize u16 | key … data …
    - leaf: datasize = lo | hi<<16; F_BIGDATA(0x01) → data is a u64
      overflow pgno instead of inline bytes
    - branch: child pgno = lo | hi<<16 | flags<<32 (48-bit)
  meta (after the header of pages 0 and 1): magic u32 = 0xBEEFC0DE |
      version u32 | address u64 | mapsize u64 | dbs[2] (48 bytes each:
      pad u32 | flags u16 | depth u16 | branch u64 | leaf u64 |
      overflow u64 | entries u64 | root u64) | last_pg u64 | txnid u64.
      dbs[0].pad doubles as the environment page size; dbs[1] is the
      main DB.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_DUPDATA = 0x04

PAGEHDRSZ = 16
_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class LMDBFormatError(RuntimeError):
    pass


class LMDBReader:
    """Read-only iterator over the main database of an LMDB environment.

    ``path`` may be the environment directory (containing ``data.mdb``) or
    the data file itself — mirroring ``lmdb.open(dir)`` usage in the
    reference (dataset_tool.py:122).
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, 'data.mdb')
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.path = path
        self._f = open(path, 'rb')
        self._mm = None
        try:
            try:
                self._mm = mmap.mmap(self._f.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except ValueError:
                raise LMDBFormatError(f'{path}: empty file')
            self.psize, self.entries, self._root = self._read_meta()
        except BaseException:
            self.close()
            raise

    # -- file structure ----------------------------------------------------

    def _read_meta(self):
        mm = self._mm
        # page 0 is always at offset 0; its meta carries the page size in
        # dbs[0].pad, which locates meta page 1
        magic, version = struct.unpack_from('<II', mm, PAGEHDRSZ)
        if magic != MDB_MAGIC:
            raise LMDBFormatError(
                f'{self.path}: bad magic {magic:#x} (not an LMDB data file)')
        if version != MDB_DATA_VERSION:
            raise LMDBFormatError(
                f'{self.path}: unsupported LMDB data version {version}')
        psize = struct.unpack_from('<I', mm, PAGEHDRSZ + 24)[0]
        if psize < 512 or psize > 0x10000 or psize & (psize - 1):
            raise LMDBFormatError(f'{self.path}: implausible page size '
                                  f'{psize}')

        def meta_at(off):
            m, v = struct.unpack_from('<II', mm, off)
            if m != MDB_MAGIC or v != MDB_DATA_VERSION:
                return None
            # main DB record at +72: pad u32 flags u16 depth u16, then
            # branch/leaf/overflow u64, entries u64, root u64
            flags, = struct.unpack_from('<H', mm, off + 72 + 4)
            # entries at db+32, root at db+40
            entries, root = struct.unpack_from('<QQ', mm, off + 72 + 32)
            txnid, = struct.unpack_from('<Q', mm, off + 128)
            return txnid, flags, entries, root

        metas = [meta_at(PAGEHDRSZ), meta_at(psize + PAGEHDRSZ)]
        metas = [m for m in metas if m is not None]
        if not metas:
            raise LMDBFormatError(f'{self.path}: no valid meta page')
        txnid, flags, entries, root = max(metas)
        if flags & 0x04:  # MDB_DUPSORT on the main DB
            raise LMDBFormatError(
                f'{self.path}: main DB uses MDB_DUPSORT — unsupported '
                f'(dataset archives are plain key→value)')
        return psize, entries, root

    def _page(self, pgno: int) -> Tuple[int, int]:
        """(byte offset, flags) of page ``pgno``, bounds-checked.  A valid
        data file holds whole pages, so a page cut at EOF means truncation."""
        off = pgno * self.psize
        if off + self.psize > len(self._mm):
            raise LMDBFormatError(f'{self.path}: page {pgno} out of range '
                                  f'(truncated file?)')
        flags, = struct.unpack_from('<H', self._mm, off + 10)
        return off, flags

    def _iter_page(self, pgno: int, depth: int) -> Iterator[Tuple[bytes, bytes]]:
        if depth > 64:  # a real LMDB tree is ≤ ~32 levels; cycles would loop
            raise LMDBFormatError(f'{self.path}: B+tree deeper than 64 — '
                                  f'corrupt (cycle?)')
        mm = self._mm
        off, flags = self._page(pgno)
        if flags & P_LEAF2:
            raise LMDBFormatError(f'{self.path}: LEAF2 (DUPFIXED) pages '
                                  f'unsupported')
        if not flags & (P_BRANCH | P_LEAF):
            raise LMDBFormatError(f'{self.path}: page {pgno} is neither '
                                  f'branch nor leaf (flags {flags:#x})')
        lower, = struct.unpack_from('<H', mm, off + 12)
        nkeys = (lower - PAGEHDRSZ) >> 1
        if nkeys < 0 or lower > self.psize:
            raise LMDBFormatError(f'{self.path}: page {pgno} bad bounds')
        page_end = off + self.psize
        for i in range(nkeys):
            ptr, = struct.unpack_from('<H', mm, off + PAGEHDRSZ + 2 * i)
            node = off + ptr
            if ptr < PAGEHDRSZ or node + 8 > page_end:
                raise LMDBFormatError(f'{self.path}: page {pgno} node ptr '
                                      f'{ptr:#x} out of page bounds')
            lo, hi, nflags, ksize = struct.unpack_from('<HHHH', mm, node)
            if flags & P_BRANCH:
                if node + 8 + ksize > page_end:
                    raise LMDBFormatError(f'{self.path}: page {pgno} branch '
                                          f'key out of page bounds')
                child = lo | hi << 16 | nflags << 32
                yield from self._iter_page(child, depth + 1)
                continue
            if nflags & F_DUPDATA:
                raise LMDBFormatError(f'{self.path}: DUPSORT data '
                                      f'unsupported')
            datasize = lo | hi << 16
            inline = 8 if nflags & F_BIGDATA else datasize
            if node + 8 + ksize + inline > page_end:
                raise LMDBFormatError(f'{self.path}: page {pgno} node '
                                      f'content out of page bounds '
                                      f'(truncated/corrupt file)')
            key = bytes(mm[node + 8: node + 8 + ksize])
            if nflags & F_BIGDATA:
                ovf_pgno, = struct.unpack_from('<Q', mm, node + 8 + ksize)
                ovf_off, ovf_flags = self._page(ovf_pgno)
                if not ovf_flags & P_OVERFLOW:
                    raise LMDBFormatError(
                        f'{self.path}: page {ovf_pgno} expected overflow')
                start = ovf_off + PAGEHDRSZ
                if start + datasize > len(mm):
                    raise LMDBFormatError(
                        f'{self.path}: overflow value out of range')
                value = bytes(mm[start: start + datasize])
            else:
                dstart = node + 8 + ksize
                value = bytes(mm[dstart: dstart + datasize])
            yield key, value

    # -- public API ----------------------------------------------------------

    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value) pairs of the main DB in key order — the pure
        equivalent of the reference's ``txn.cursor()`` scan
        (dataset_tool.py:126-127)."""
        if self._root == _INVALID_PGNO:
            return
        yield from self._iter_page(self._root, 0)

    def close(self):
        if self._mm is not None:
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
