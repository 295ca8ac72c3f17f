"""Minimal pure-Python read-only LMDB parser (LSUN ingestion).

A copy of next3d_tpu/data/lmdb_reader.py (stdlib only), so that the port
imports nothing of the JAX package; tests/test_torch_data_tools.py holds it
to the original.

The reference's dataset_tool ingests LSUN via ``lmdb.open(...).cursor()``
(reference dataset_tool.py:255-292 ``open_lmdb``). Neither the ``lmdb``
wheel nor liblmdb exists in this environment, so this module reads the
on-disk format directly: an LMDB environment is a single memory-mapped
file (``data.mdb``) of fixed-size pages holding two meta pages and a
copy-on-write B+tree. Reading the committed tree only needs:

  * the newer of the two meta pages (largest txnid, valid magic),
  * a depth-first walk of the main DB's B+tree (branch / leaf pages),
  * overflow-page reassembly for values larger than a page.

Layout constants follow the stable v1 data format (lmdb.h
``MDB_DATA_VERSION``; struct offsets from mdb.c for 64-bit builds — the
only builds that produce >4 GB LSUN files). Write support, nested
(named) databases, and DUPSORT trees are intentionally out of scope:
LSUN exports store everything in the main DB with plain keys.
"""

from __future__ import annotations

import mmap
import os
import struct

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

# page flags (mdb.c)
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16

# MDB_meta, at PAGEHDRSZ within a meta page (64-bit):
#   u32 magic; u32 version; void* address; size_t mapsize;
#   MDB_db dbs[2]; pgno_t last_pg; txnid_t txnid;
# MDB_db: u32 pad; u16 flags; u16 depth; pgno_t branch_pages, leaf_pages,
#   overflow_pages; size_t entries; pgno_t root;  (48 bytes)
_META = struct.Struct('<II8x8x')          # magic, version (skip addr+mapsize)
_DB = struct.Struct('<IHHQQQQq')          # pad..root (root signed: -1 = empty)
_META_DBS_OFF = PAGEHDRSZ + 24
_META_TXNID_OFF = _META_DBS_OFF + 2 * _DB.size + 8


class LMDBFormatError(RuntimeError):
    pass


class _MainDB:
    __slots__ = ('pad', 'flags', 'depth', 'entries', 'root')

    def __init__(self, raw):
        (self.pad, self.flags, self.depth, _bp, _lp, _op,
         self.entries, self.root) = _DB.unpack(raw)


class LMDBReader:
    """Read-only iterator over the main database of an LMDB environment.

    ``path`` may be the environment directory (containing ``data.mdb``)
    or the data file itself. Usage::

        with LMDBReader('/data/lsun/bedroom_train_lmdb') as r:
            for key, value in r.items():
                ...
    """

    def __init__(self, path):
        if os.path.isdir(path):
            path = os.path.join(path, 'data.mdb')
        self._f = open(path, 'rb')
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        # mm_dbs[0].md_pad aliases the environment page size (mdb.c mm_psize)
        free_db = _MainDB(self._meta_db_raw(meta, 0))
        self.psize = free_db.pad
        if self.psize < 512 or self.psize & (self.psize - 1):
            raise LMDBFormatError(f'implausible page size {self.psize}')
        self.main = _MainDB(self._meta_db_raw(meta, 1))
        if self.main.flags & 0x04:  # MDB_DUPSORT
            raise LMDBFormatError('DUPSORT main DB is not supported')

    # -- meta ----------------------------------------------------------
    def _meta_db_raw(self, meta_off, i):
        off = meta_off + _META_DBS_OFF + i * _DB.size
        return self._mm[off:off + _DB.size]

    def _pick_meta(self):
        # meta 0 sits at offset 0; meta 1 at offset psize. psize is
        # discoverable from meta 0 itself when it is valid; if not (torn
        # first page), probe the common page sizes for meta 1.
        cand = [0]
        if self._meta_at(0) is not None:
            psize = _MainDB(self._meta_db_raw(0, 0)).pad
            if 512 <= psize <= 65536 and not (psize & (psize - 1)):
                cand.append(psize)
        else:
            cand += [4096, 8192, 16384, 32768]
        best, best_txn = None, -1
        for off in cand:
            txn = self._meta_at(off)
            if txn is not None and txn > best_txn:
                best, best_txn = off, txn
        if best is None:
            raise LMDBFormatError('no valid LMDB meta page found')
        return best

    def _meta_at(self, off):
        try:
            magic, version = _META.unpack(
                self._mm[off + PAGEHDRSZ:off + PAGEHDRSZ + _META.size])
        except struct.error:
            return None
        if magic != MAGIC or version != DATA_VERSION:
            return None
        return struct.unpack(
            '<Q', self._mm[off + _META_TXNID_OFF:off + _META_TXNID_OFF + 8])[0]

    # -- pages ---------------------------------------------------------
    def _page(self, pgno):
        off = pgno * self.psize
        if off + self.psize > len(self._mm):
            raise LMDBFormatError(f'page {pgno} beyond end of file')
        return off

    def _page_meta(self, off):
        flags, lower = struct.unpack('<HH', self._mm[off + 10:off + 14])
        nkeys = (lower - PAGEHDRSZ) // 2
        return flags, nkeys

    def _node(self, page_off, i):
        ptr = struct.unpack(
            '<H', self._mm[page_off + PAGEHDRSZ + 2 * i:
                           page_off + PAGEHDRSZ + 2 * i + 2])[0]
        off = page_off + ptr
        lo, hi, flags, ksize = struct.unpack('<HHHH',
                                             self._mm[off:off + 8])
        return off, lo, hi, flags, ksize

    # -- traversal -----------------------------------------------------
    def items(self):
        """Yield (key, value) bytes over the main DB in key order."""
        if self.main.root < 0:
            return
        yield from self._walk(self.main.root)

    def _walk(self, pgno):
        page_off = self._page(pgno)
        flags, nkeys = self._page_meta(page_off)
        if flags & P_LEAF2:
            raise LMDBFormatError('LEAF2 (DUPFIXED) pages not supported')
        if flags & P_BRANCH:
            for i in range(nkeys):
                _, lo, hi, nflags, _ = self._node(page_off, i)
                # branch pgno spans lo | hi<<16 | flags<<32 (mdb.c NODEPGNO)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        elif flags & P_LEAF:
            for i in range(nkeys):
                off, lo, hi, nflags, ksize = self._node(page_off, i)
                key = bytes(self._mm[off + 8:off + 8 + ksize])
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    ovpg = struct.unpack(
                        '<Q', self._mm[off + 8 + ksize:off + 16 + ksize])[0]
                    yield key, self._overflow(ovpg, dsize)
                elif nflags & (F_SUBDATA | F_DUPDATA):
                    raise LMDBFormatError('sub-databases not supported')
                else:
                    doff = off + 8 + ksize
                    yield key, bytes(self._mm[doff:doff + dsize])
        else:
            raise LMDBFormatError(f'unexpected page flags {flags:#x}')

    def _overflow(self, pgno, dsize):
        off = self._page(pgno)
        oflags, _ = self._page_meta(off)
        if not oflags & P_OVERFLOW:
            raise LMDBFormatError('BIGDATA node points at a non-overflow page')
        # data starts after the first page header and runs contiguously;
        # a value spanning several pages must fit entirely in the file —
        # a silent short mmap slice would masquerade as a corrupt image
        start = off + PAGEHDRSZ
        if start + dsize > len(self._mm):
            raise LMDBFormatError(
                f'truncated data.mdb: overflow value at page {pgno} needs '
                f'{start + dsize} bytes, file has {len(self._mm)}')
        return bytes(self._mm[start:start + dsize])

    def __len__(self):
        return self.main.entries

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        self._mm.close()
        self._f.close()
