"""arts-crossfit coefficient download (counterpart of
pylbl_tpu/webapi/arts_crossfit_api.py).

Fetches the UHH cross-section fit coefficients archive (37 molecules), the
data source of the reference (reference pyLBL/arts_crossfit/webapi.py:1-16),
and unpacks it in memory: the archive is held in a BytesIO, so no
temporary zip file ever touches ``directory``.
"""
import io
import zipfile
from urllib.request import urlopen

URL = "https://attachment.rrz.uni-hamburg.de/df514eed/coefficients.zip"


def download(directory, name=None, url=URL):
    """Downloads and unpacks the coefficients archive into ``directory``.

    Args:
        directory: destination directory for the per-molecule netCDF files.
        name: unused (kept for call-compatibility with callers that pass
            the reference's temporary-file name).
        url: archive URL (a ``file://`` URL reads a local archive).

    Returns:
        The destination directory.
    """
    del name
    with urlopen(url) as response:
        archive = zipfile.ZipFile(io.BytesIO(response.read()))
    archive.extractall(directory)
    return directory
