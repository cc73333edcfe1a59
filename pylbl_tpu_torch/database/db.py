"""Spectral database over stdlib sqlite3 (the read side).

Counterpart of pylbl_tpu/database/db.py, on the same schema (reference
pyLBL/database.py:130-506): tables molecule / isotopologue / molecule_alias
/ transition / tips / artscrossfit / metadata and the same exception
taxonomy, so either package opens the other's files.  It covers queries,
:meth:`Database.line_pack` (a molecule's lines packed once into the
structure-of-arrays the device pipeline consumes) and the offline
ingestion of LinePacks and cross-section directories.  Downloading from
the HITRAN/TIPS web services (``create``) is not ported.
"""
import sqlite3
from os import listdir
from os.path import abspath, join
from re import match

import numpy as np

from ..models.lines.physics import LinePack

SCHEMA = """
CREATE TABLE IF NOT EXISTS molecule (
    id INTEGER PRIMARY KEY,
    stoichiometric_formula TEXT,
    ordinary_formula TEXT,
    common_name TEXT
);
CREATE TABLE IF NOT EXISTS isotopologue (
    id INTEGER PRIMARY KEY,
    molecule_id INTEGER REFERENCES molecule(id),
    isoid INTEGER,
    iso_name TEXT,
    abundance REAL,
    mass REAL
);
CREATE TABLE IF NOT EXISTS molecule_alias (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    alias TEXT,
    molecule INTEGER REFERENCES molecule(id)
);
CREATE TABLE IF NOT EXISTS transition (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    global_iso_id INTEGER,
    molecule_id INTEGER REFERENCES molecule(id),
    local_iso_id INTEGER,
    nu REAL, sw REAL, gamma_air REAL, gamma_self REAL,
    n_air REAL, delta_air REAL, elower REAL
);
CREATE TABLE IF NOT EXISTS tips (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    molecule_id INTEGER REFERENCES molecule(id),
    isotopologue_id INTEGER,
    temperature REAL,
    data REAL
);
CREATE TABLE IF NOT EXISTS artscrossfit (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    molecule_id INTEGER REFERENCES molecule(id),
    path TEXT
);
CREATE TABLE IF NOT EXISTS metadata (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    molecule_id INTEGER REFERENCES molecule(id),
    database TEXT,
    time TEXT
);
CREATE INDEX IF NOT EXISTS transition_molecule
    ON transition (molecule_id);
"""


class AliasNotFoundError(BaseException):
    pass


class TipsDataNotFoundError(BaseException):
    pass


class IsotopologuesNotFoundError(BaseException):
    pass


class TransitionsNotFoundError(BaseException):
    pass


class CrossSectionNotFoundError(BaseException):
    pass


class Database:
    """Spectral line parameter database.

    Attributes:
        path: path to the sqlite file.
    """

    def __init__(self, path):
        """Connects to the database and creates tables.

        Args:
            path: path to the sqlite file.
        """
        self.path = str(path)
        con = self._connect()
        con.executescript(SCHEMA)
        con.commit()
        con.close()
        self._pack_cache = {}

    def _connect(self):
        return sqlite3.connect(self.path)

    # ------------------------------ ingest ------------------------------

    def ingest_arts_crossfit_directory(self, directory, molecules="all"):
        """Records per-molecule cross-section file paths, adding molecules
        that only exist as cross sections (reference database.py:225-277)."""
        con = self._connect()
        for path in sorted(listdir(directory)):
            regex = match(r"([A-Za-z0-9]+).nc", path)
            if not regex:
                continue
            formula = regex.group(1)
            if molecules != "all" and formula not in molecules:
                continue
            row = con.execute(
                "SELECT molecule FROM molecule_alias WHERE alias == ?",
                (formula,)).fetchone()
            if row is None:
                cur = con.execute(
                    "INSERT INTO molecule (stoichiometric_formula, "
                    "ordinary_formula, common_name) VALUES (?, ?, ?)",
                    (formula, formula, formula))
                molecule_id = cur.lastrowid
                con.execute(
                    "INSERT INTO molecule_alias (alias, molecule) "
                    "VALUES (?, ?)", (formula, molecule_id))
            else:
                molecule_id = row[0]
            con.execute(
                "INSERT INTO artscrossfit (molecule_id, path) VALUES (?, ?)",
                (molecule_id, abspath(join(directory, path))))
        con.commit()
        con.close()

    # ------------------------------ queries -----------------------------

    def _molecule_id(self, con, name):
        row = con.execute(
            "SELECT molecule FROM molecule_alias WHERE alias == ?",
            (name,)).fetchone()
        if row is None:
            raise AliasNotFoundError(f"{name} not found in database.")
        return row[0]

    def molecules(self):
        """All molecule formulae (reference database.py:340-348)."""
        con = self._connect()
        try:
            return [r[0] for r in con.execute(
                "SELECT ordinary_formula FROM molecule")]
        finally:
            con.close()

    def tips(self, name):
        """(temperature[nT], data[nIso, nT]) for a molecule
        (reference database.py:369-395)."""
        con = self._connect()
        try:
            molecule_id = self._molecule_id(con, name)
            rows = con.execute(
                "SELECT temperature, data FROM tips WHERE molecule_id == ? "
                "ORDER BY id", (molecule_id,)).fetchall()
        finally:
            con.close()
        if not rows:
            raise TipsDataNotFoundError(f"no tips data for {name}.")
        data, temperature = [], []
        for temp, value in rows:
            data.append(value)
            if temp not in temperature:
                temperature.append(temp)
        data = np.reshape(np.asarray(data),
                          (len(data) // len(temperature), len(temperature)))
        return np.asarray(temperature), data

    def arts_crossfit(self, name):
        """Path to a molecule's cross-section file
        (reference database.py:397-415)."""
        con = self._connect()
        try:
            molecule_id = self._molecule_id(con, name)
            row = con.execute(
                "SELECT path FROM artscrossfit WHERE molecule_id == ?",
                (molecule_id,)).fetchone()
        finally:
            con.close()
        if row is None:
            raise CrossSectionNotFoundError(f"No cross sections for {name}.")
        return row[0]

    # ------------------------------ packing -----------------------------

    def line_pack(self, name):
        """Packs a molecule's line list into device-ready SoA arrays.

        Replaces the reference C path's per-call sqlite reads (reference
        absorption.c:44-73, spectral_database.c:49-180): transitions, the
        32-slot isotopologue mass array (with the isoid 0 -> 10 remap) and
        the TIPS matrix are read once and cached.
        """
        cached = self._pack_cache.get(name)
        if cached is not None:
            return cached
        con = self._connect()
        try:
            molecule_id = self._molecule_id(con, name)
            rows = con.execute(
                "SELECT nu, sw, gamma_air, gamma_self, n_air, elower, "
                "delta_air, local_iso_id FROM transition "
                "WHERE molecule_id == ? ORDER BY id",
                (molecule_id,)).fetchall()
            if not rows:
                raise TransitionsNotFoundError(
                    f"transitions not found for molecule {molecule_id}.")
            iso_rows = con.execute(
                "SELECT isoid, mass FROM isotopologue "
                "WHERE molecule_id == ? ORDER BY id",
                (molecule_id,)).fetchall()
            if not iso_rows:
                raise IsotopologuesNotFoundError(
                    f"isotopologues not found for molecule {molecule_id}.")
        finally:
            con.close()
        data = np.asarray(rows, dtype=np.float64)
        iso = data[:, 7].astype(np.int64)
        iso = np.where(iso == 0, 10, iso)  # spectral_database.c:173-177.
        mass_slots = np.zeros(32)
        for isoid, mass in iso_rows:
            isoid = 10 if isoid == 0 else isoid  # spectral_database.c:118-123
            if isoid - 1 < 32:
                mass_slots[isoid - 1] = mass
        temperature, q_table = self.tips(name)
        pack = LinePack(
            formula=name, nu=data[:, 0], sw=data[:, 1],
            gamma_air=data[:, 2], gamma_self=data[:, 3], n_air=data[:, 4],
            elower=data[:, 5], delta_air=data[:, 6], iso=iso,
            mass_slots=mass_slots, q_table=q_table,
            q_temperature=temperature, meta={"source": self.path})
        self._pack_cache[name] = pack
        return pack

    def ingest_line_pack(self, pack, molecule_id=None, aliases=()):
        """Inserts a LinePack directly (offline fixtures, tests, caches)."""
        con = self._connect()
        if molecule_id is None:
            cur = con.execute(
                "INSERT INTO molecule (stoichiometric_formula, "
                "ordinary_formula, common_name) VALUES (?, ?, ?)",
                (pack.formula, pack.formula, pack.formula))
            molecule_id = cur.lastrowid
        for alias in set((pack.formula,) + tuple(aliases)):
            con.execute(
                "INSERT INTO molecule_alias (alias, molecule) VALUES (?, ?)",
                (alias, molecule_id))
        iso_ids = sorted({int(i) for i in pack.iso})
        for isoid in iso_ids:
            con.execute(
                "INSERT INTO isotopologue (molecule_id, isoid, iso_name, "
                "abundance, mass) VALUES (?, ?, ?, ?, ?)",
                (molecule_id, 0 if isoid == 10 else isoid,
                 f"{pack.formula}-{isoid}", 1.0,
                 float(pack.mass_slots[isoid - 1])))
        con.executemany(
            "INSERT INTO transition (global_iso_id, molecule_id, "
            "local_iso_id, nu, sw, gamma_air, gamma_self, n_air, "
            "delta_air, elower) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            [(0, molecule_id, 0 if int(i) == 10 else int(i), nu, sw, ga,
              gs, na, da, el)
             for nu, sw, ga, gs, na, da, el, i in zip(
                 pack.nu, pack.sw, pack.gamma_air, pack.gamma_self,
                 pack.n_air, pack.delta_air, pack.elower, pack.iso)])
        rows = []
        for x in range(pack.q_table.shape[0]):
            for y in range(pack.q_table.shape[1]):
                rows.append((molecule_id, x, float(pack.q_temperature[y]),
                             float(pack.q_table[x, y])))
        con.executemany(
            "INSERT INTO tips (molecule_id, isotopologue_id, temperature, "
            "data) VALUES (?, ?, ?, ?)", rows)
        con.commit()
        con.close()
        return molecule_id
