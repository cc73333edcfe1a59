"""HITRAN web API client (counterpart of pylbl_tpu/webapi/hitran_api.py).

The REST contract of the reference client (reference
pyLBL/webapi/hitran_api.py:8-248): v2 endpoints for server info, parameter
metadata, molecules, isotopologues, CSV transition result files and
cross-section files.  Server info and parameter metadata are fetched on
first use, so the client constructs offline; the CSV row parsing is the
module function :func:`parse_transitions`, testable without a server.
"""
import io
import shutil
from json import loads
from types import SimpleNamespace
from urllib.error import HTTPError
from urllib.request import build_opener, install_opener, ProxyHandler, urlopen


class NoCrossSectionError(BaseException):
    pass


class NoIsotopologueError(BaseException):
    pass


class NoTransitionsError(BaseException):
    pass


# API records are plain attribute bags (the reference's record type,
# reference hitran_api.py:246-248).
Struct = SimpleNamespace

# Read sizes: whole result files in large blocks, API sections in 1 MiB.
FILE_CHUNK = 1 << 26
SECTION_CHUNK = 1 << 20


def _scalar(value):
    if isinstance(value, (bool, float, int, str)):
        return str(value)
    raise TypeError(f"bad type for query: '{value}'")


def query_string(**params):
    """Serializes kwargs to the HITRAN REST query-string dialect: scalars
    verbatim, sequences comma-joined (no percent-encoding: the server
    expects raw commas)."""
    parts = []
    for key, value in params.items():
        if isinstance(value, (list, set, tuple)):
            encoded = ",".join(_scalar(v) for v in value)
        else:
            encoded = _scalar(value)
        parts.append(f"{key}={encoded}")
    return "&".join(parts)


def parse_transitions(data, parameters, types):
    """Parses a HITRAN CSV results file into Structs, skipping malformed
    rows with a warning (reference hitran_api.py:173-185)."""
    transitions = []
    for line in data.split("\n"):
        line = line.strip()
        if not line:
            continue
        try:
            transitions.append(Struct(**{
                name: cast(cell) for name, cast, cell in
                zip(parameters, types, line.split(","))}))
        except ValueError:
            print(f"skipping transition: {line}")
    return transitions


def _as_sequence(records):
    """One record or a list/tuple of them, as a sequence."""
    return records if isinstance(records, (list, tuple)) else [records]


class HitranWebApi:
    """Access to the hitran.org REST API.

    Attributes:
        api_key: hitran.org API key string.
        host: server URL.
        parameters: list of Structs describing available line parameters.
    """

    def __init__(self, api_key, api_version="v2", host="https://hitran.org",
                 proxy=None):
        """Constructs the client without touching the network; server info
        and parameter metadata are fetched lazily on first use."""
        self.api_key = api_key
        self.api_version = api_version
        self.host = host
        self.proxy = proxy
        self._server_info = None
        self._parameters = None

    def _info(self):
        if self._server_info is None:
            self._server_info = self._download_section("info")
        return self._server_info

    @property
    def transition_directory(self):
        return self._info()["content"]["data"]["results_dir"]

    @property
    def cross_section_directory(self):
        return self._info()["content"]["data"]["xsec_dir"]

    @property
    def timestamp(self):
        return self._info()["timestamp"]

    @property
    def parameters(self):
        if self._parameters is None:
            self._parameters = self._download_parameters_metadata()
        return self._parameters

    def _download(self, url, chunk):
        """The body at ``url`` as text, read ``chunk`` bytes at a time."""
        if self.proxy:
            install_opener(build_opener(ProxyHandler(self.proxy)))
        body = io.BytesIO()
        with urlopen(url) as response:
            shutil.copyfileobj(response, body, chunk)
        return body.getvalue().decode("utf-8")

    def _download_file(self, prefix, name, chunk=FILE_CHUNK):
        return self._download("/".join([self.host, prefix, name]), chunk)

    def _download_section(self, api_section, query=None, chunk=SECTION_CHUNK):
        url = "/".join([self.host, "api", self.api_version, self.api_key,
                        api_section])
        if query is not None:
            url = "?".join([url, query])
        return loads(self._download(url, chunk))

    def _section_data(self, api_section, query=None):
        return self._download_section(api_section, query)["content"]["data"]

    def _per_molecule(self, api_section, molecules):
        """A section's records for the molecules' ids."""
        ids = [molecule.id for molecule in _as_sequence(molecules)]
        return self._section_data(api_section,
                                  query_string(molecule_id__in=ids))

    def _download_parameters_metadata(self, pattern=None):
        query = None if pattern is None else query_string(
            name__icontains=pattern)
        return [Struct(**x)
                for x in self._section_data("parameter-metas", query)]

    def download_data_sources(self, ids=None):
        query = None if ids is None else query_string(id__in=ids)
        return self._section_data("sources", query)

    def download_molecules(self):
        return [Struct(**x) for x in self._section_data("molecules")]

    def download_isotopologues(self, molecules):
        records = self._per_molecule("isotopologues", molecules)
        return [Struct(**record) for record in records]

    def download_transitions_csv(self, isotopologues, numin, numax,
                                 parameters=None):
        """Downloads the raw CSV results file for a set of isotopologues.

        Returns:
            (csv_text, parameters): the ingest path hands the text to the
            native parser (runtime/native.py) instead of Python row
            splitting.
        """
        isotopologues = _as_sequence(isotopologues)
        ids = [x.id for x in isotopologues]
        if not ids:
            raise NoIsotopologueError("no isotopologues present.")
        if parameters is None:
            parameters = [x.name for x in self.parameters][:22]
        query = query_string(iso_ids_list=ids, numin=numin, numax=numax,
                             head=False, fixwidth=0,
                             request_params=",".join(parameters))
        try:
            name = self._section_data("transitions", query)
        except HTTPError:
            raise NoTransitionsError(
                f"no transitions found for "
                f"{isotopologues[0].molecule_alias}.")
        return self._download_file(self.transition_directory,
                                   name), parameters

    def download_transitions(self, isotopologues, numin, numax,
                             parameters=None):
        data, parameters = self.download_transitions_csv(
            isotopologues, numin, numax, parameters)
        type_mapping = {"float": float, "int": int, "str": str}
        types = [type_mapping[x.type] for x in self.parameters]
        return parse_transitions(data, parameters, types)

    def download_cross_sections(self, molecules):
        """One Struct per cross-section band: the band's record with its
        file's text under ``data`` (a ``data`` key of the record wins).
        The server info is fetched, if at all, after the band list."""
        bands = self._per_molecule("cross-sections", molecules)
        return [Struct(**{"data": self._download_file(
                    self.cross_section_directory, band["filename"]), **band})
                for band in bands]
