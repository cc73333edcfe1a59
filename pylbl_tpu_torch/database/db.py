"""Spectral database over stdlib sqlite3 (the read side).

Counterpart of pylbl_tpu/database/db.py, on the same schema (reference
pyLBL/database.py:130-506): tables molecule / isotopologue / molecule_alias
/ transition / tips / artscrossfit / metadata and the same exception
taxonomy, so either package opens the other's files.  It covers
:meth:`Database.create` (molecules, isotopologues, transitions and TIPS
tables from the HITRAN and TIPS web clients, one commit per molecule,
transition CSV text through the native parser, then the arts-crossfit
coefficients), queries, :meth:`Database.line_pack` (a molecule's lines
packed once into the structure-of-arrays the device pipeline consumes) and
the offline ingestion of LinePacks and cross-section directories, with an
optional on-disk npz cache of the packs.
"""
import sqlite3
from itertools import repeat
from os import listdir
from os.path import abspath, join
from pathlib import Path
from re import match

import numpy as np

from .. import webapi
from ..models.lines.physics import LinePack
from ..models.tips import TotalPartitionFunction
from ..runtime import native
from ..utils.observability import metrics

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

# The transition parameters requested from the server: the columns of
# the CSV text the native parser reads; the float columns in the order of
# the transition table.
TRANSITION_PARAMETERS = [name for name, _ in native.CSV_COLUMNS]
TRANSITION_FLOATS = ("nu", "sw", "gamma_air", "gamma_self", "n_air",
                     "delta_air", "elower")
INSERT_TRANSITION = (
    "INSERT INTO transition (global_iso_id, molecule_id, local_iso_id, nu, "
    "sw, gamma_air, gamma_self, n_air, delta_air, elower) "
    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)")


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

    def __init__(self, path, echo=False, pack_cache_dir=None):
        """Connects to the database and creates tables.

        Args:
            path: path to the sqlite file.
            echo: print SQL statements.
            pack_cache_dir: optional directory for on-disk LinePack npz
                caches (sqlite is then queried once per molecule ever).
        """
        self.path = str(path)
        self.echo = echo
        self.cross_section_directory = None
        self.pack_cache_dir = pack_cache_dir
        con = self._connect()
        con.executescript(SCHEMA)
        con.commit()
        con.close()
        self._pack_cache = {}

    def _connect(self):
        con = sqlite3.connect(self.path)
        if self.echo:
            con.set_trace_callback(print)
        return con

    # ------------------------------ ingest ------------------------------

    def create(self, hitran_webapi, molecules="all", tips_webapi=None,
               cross_section_directory=".cross-sections"):
        """Downloads HITRAN, TIPS and cross-section data into the database
        (the flow of reference database.py:148-210).

        Args:
            hitran_webapi: a HitranWebApi (or any object with its
                ``download_molecules``, ``download_isotopologues`` and
                ``download_transitions_csv`` or ``download_transitions``).
            molecules: "all" or a list of ordinary formulae.
            tips_webapi: a TipsWebApi-like client (default: TipsWebApi()).
            cross_section_directory: where the arts-crossfit coefficients
                are unpacked; None skips them (ingest them later with
                :meth:`ingest_arts_crossfit_directory`).

        A molecule whose transitions or TIPS table are missing is reported
        and skipped; each complete molecule is committed on its own.
        """
        if tips_webapi is None:
            tips_webapi = webapi.TipsWebApi()

        con = self._connect()
        all_molecules = hitran_webapi.download_molecules()
        total = len(all_molecules) if molecules == "all" else len(molecules)
        for i, molecule in enumerate(all_molecules):
            formula = molecule.ordinary_formula
            if molecules != "all" and formula not in molecules:
                continue
            print(f"Working on molecule {i + 1} / {total} ({formula})")
            self._ingest_molecule(con, molecule)
            isotopologues = hitran_webapi.download_isotopologues(molecule)
            self._ingest_isotopologues(con, molecule, isotopologues)
            try:
                self._ingest_transitions(con, molecule, isotopologues,
                                         hitran_webapi)
            except webapi.NoIsotopologueError:
                print(f"No isotopologues for molecule {formula}.")
                continue
            except webapi.NoTransitionsError:
                print(f"No transitions for molecule {formula}.")
                continue
            try:
                self._ingest_tips(con, molecule, tips_webapi)
            except webapi.NoMoleculeError:
                print(f"No molecule {formula} found in TIPS database.")
                continue
            con.commit()
        con.commit()
        con.close()

        if cross_section_directory is None:
            return
        self.cross_section_directory = cross_section_directory
        Path(cross_section_directory).mkdir(parents=True, exist_ok=True)
        webapi.arts_crossfit_api.download(cross_section_directory)
        self.ingest_arts_crossfit_directory(
            join(cross_section_directory, "coefficients"), molecules)

    def _ingest_molecule(self, con, molecule):
        con.execute(
            "INSERT INTO molecule (id, stoichiometric_formula, "
            "ordinary_formula, common_name) VALUES (?, ?, ?, ?)",
            (molecule.id, molecule.stoichiometric_formula,
             molecule.ordinary_formula, molecule.common_name))
        con.executemany(
            "INSERT INTO molecule_alias (alias, molecule) VALUES (?, ?)",
            [(x["alias"], molecule.id) for x in molecule.aliases])

    def _ingest_isotopologues(self, con, molecule, isotopologues):
        con.executemany(
            "INSERT INTO isotopologue (id, molecule_id, isoid, iso_name, "
            "abundance, mass) VALUES (?, ?, ?, ?, ?, ?)",
            [(iso.id, molecule.id, iso.isoid, iso.iso_name, iso.abundance,
              iso.mass) for iso in isotopologues])

    def _ingest_transitions(self, con, molecule, isotopologues,
                            hitran_webapi):
        """One molecule's transitions over 0-1e8 cm-1.  A client with
        ``download_transitions_csv`` hands its CSV text to the native
        parser (the reference splits rows in Python,
        hitran_api.py:173-185); otherwise its ``download_transitions``
        records are inserted."""
        if hasattr(hitran_webapi, "download_transitions_csv"):
            text, _ = hitran_webapi.download_transitions_csv(
                isotopologues, 0.0, 1.0e8, TRANSITION_PARAMETERS)
            columns = native.parse_transitions_csv(text)
            rows = zip(columns["global_iso_id"].tolist(),
                       repeat(molecule.id, columns["nu"].size),
                       columns["local_iso_id"].tolist(),
                       *(columns[k].tolist() for k in TRANSITION_FLOATS))
        else:
            rows = [(t.global_iso_id, molecule.id, t.local_iso_id,
                     *(getattr(t, k) for k in TRANSITION_FLOATS))
                    for t in hitran_webapi.download_transitions(
                        isotopologues, 0.0, 1.0e8, TRANSITION_PARAMETERS)]
        con.executemany(INSERT_TRANSITION, rows)

    def _ingest_tips(self, con, molecule, tips_webapi):
        temperature, data = tips_webapi.download(molecule.ordinary_formula)
        temperature = np.asarray(temperature).tolist()
        con.executemany(
            "INSERT INTO tips (molecule_id, isotopologue_id, temperature, "
            "data) VALUES (?, ?, ?, ?)",
            [(molecule.id, x, float(t), float(q))
             for x, row in enumerate(np.asarray(data).tolist())
             for t, q in zip(temperature, row)])

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

    def gas(self, name):
        """(formula, masses, transitions, TotalPartitionFunction) for a
        molecule (reference database.py:350-367)."""
        con = self._connect()
        try:
            molecule_id = self._molecule_id(con, name)
            formula = con.execute(
                "SELECT ordinary_formula FROM molecule WHERE id == ?",
                (molecule_id,)).fetchone()[0]
            mass = [r[0] for r in con.execute(
                "SELECT mass FROM isotopologue WHERE molecule_id == ?",
                (molecule_id,))]
            if not mass:
                raise IsotopologuesNotFoundError(
                    f"isotopologues not found for molecule {molecule_id}.")
            transitions = con.execute(
                "SELECT nu, sw, gamma_air, gamma_self, n_air, elower, "
                "delta_air, local_iso_id FROM transition "
                "WHERE molecule_id == ? ORDER BY id", (molecule_id,)
            ).fetchall()
            if not transitions:
                raise TransitionsNotFoundError(
                    f"transitions not found for molecule {molecule_id}.")
        finally:
            con.close()
        return formula, mass, transitions, \
            TotalPartitionFunction(name, *self.tips(name))

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
        # The temperature axis: distinct values in first-seen row order.
        temperature = list(dict.fromkeys(temp for temp, _ in rows))
        data = np.reshape(np.asarray([value for _, value in rows]),
                          (len(rows) // len(temperature), len(temperature)))
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
        the TIPS matrix are read once and cached, in memory and, with a
        ``pack_cache_dir``, as ``<dir>/<name>.lpk.npz``.
        """
        cached = self._pack_cache.get(name)
        if cached is not None:
            return cached
        metrics.count("database.pack_reads")
        disk = None if self.pack_cache_dir is None \
            else Path(self.pack_cache_dir) / f"{name}.lpk.npz"
        if disk is not None and disk.exists():
            pack = LinePack.load(disk)
            self._pack_cache[name] = pack
            return pack
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
        if disk is not None:
            disk.parent.mkdir(parents=True, exist_ok=True)
            pack.save(disk)
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
            INSERT_TRANSITION,
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
