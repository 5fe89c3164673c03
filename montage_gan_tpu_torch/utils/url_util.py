"""URL/file opener with retry + cache, and the transfer-learning resume
alias registry.

A copy of ``montage_gan_tpu/utils/url_util.py`` (the port imports nothing of
the JAX package).  Contract parity with the reference's
``dnnlib.util.open_url`` (reference: dnnlib/util.py:386-470) and ``train_aio.py`` resume handling
(reference: train_aio.py:333-355): a string that is not a URL scheme is a
local filename; ``file://`` URLs map to local paths; anything else is
downloaded with up to ``num_attempts`` retries into an md5-keyed cache
directory.  Built on urllib (stdlib): where there is no network a remote
fetch raises, while local paths, ``file://`` URLs, and aliases and URLs
already in the cache (``MGT_CACHE_DIR``) work offline.
"""

from __future__ import annotations

import glob
import hashlib
import io
import os
import re
import time
import urllib.parse
import urllib.request
from typing import Any, Optional, Tuple

# Predefined transfer-learning source networks
# (reference: train_aio.py:333-339; same table shape in train.py).
RESUME_SPECS = {
    'ffhq256': 'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/ffhq-res256-mirror-paper256-noaug.pkl',
    'ffhq512': 'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/ffhq-res512-mirror-stylegan2-noaug.pkl',
    'ffhq1024': 'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/ffhq-res1024-mirror-stylegan2-noaug.pkl',
    'celebahq256': 'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/celebahq-res256-mirror-paper256-kimg100000-ada-target0.5.pkl',
    'lsundog256': 'https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/transfer-learning-source-nets/lsundog-res256-paper256-kimg100000-noaug.pkl',
}


def is_url(obj: Any) -> bool:
    """Loose URL check (reference: dnnlib/util.py:364-383)."""
    if not isinstance(obj, str) or '://' not in obj:
        return False
    try:
        res = urllib.parse.urlparse(obj)
        if not res.scheme or not res.netloc or '.' not in res.netloc:
            return False
    except Exception:
        return False
    return True


def make_cache_dir_path(*paths: str) -> str:
    root = os.environ.get('MGT_CACHE_DIR',
                          os.path.join(os.path.expanduser('~'), '.cache',
                                       'montage_gan_tpu'))
    return os.path.join(root, *paths)


def open_url(url: str,
             cache_dir: Optional[str] = None,
             num_attempts: int = 10,
             verbose: bool = True,
             return_filename: bool = False,
             cache: bool = True):
    """Open a URL or local path for binary reading, with retrying download
    and an md5-keyed cache (reference: dnnlib/util.py:386-470)."""
    assert num_attempts >= 1
    assert not (return_filename and not cache)

    # Not a URL scheme → local filename.
    if not re.match('^[a-z]+://', url):
        return url if return_filename else open(url, 'rb')

    # file:// URLs → local path (drop the leading slash of /c:/… forms).
    if url.startswith('file://'):
        filename = urllib.parse.urlparse(url).path
        if re.match(r'^/[a-zA-Z]:', filename):
            filename = filename[1:]
        return filename if return_filename else open(filename, 'rb')

    assert is_url(url), url

    if cache_dir is None:
        cache_dir = make_cache_dir_path('downloads')
    url_md5 = hashlib.md5(url.encode('utf-8')).hexdigest()
    if cache:
        cache_files = glob.glob(os.path.join(cache_dir, url_md5 + '_*'))
        if len(cache_files) == 1:
            filename = cache_files[0]
            return filename if return_filename else open(filename, 'rb')

    # Download with retries (the reference's 10-attempt loop,
    # dnnlib/util.py:432-460).
    url_data = None
    url_name = None
    if verbose:
        print(f'Downloading {url} ...', end='', flush=True)
    for attempts_left in reversed(range(num_attempts)):
        try:
            with urllib.request.urlopen(url, timeout=60) as res:
                data = res.read()
                if len(data) == 0:
                    raise IOError('No data received')
                url_data = data
                match = re.search(
                    r'filename="([^"]*)"',
                    res.headers.get('Content-Disposition', ''))
                url_name = match.group(1) if match else url
            break
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            if not attempts_left:
                if verbose:
                    print(' failed')
                raise
            if verbose:
                print('.', end='', flush=True)
            time.sleep(0.1)
    if verbose:
        print(' done')

    if cache:
        safe_name = re.sub(r'[^0-9a-zA-Z-._]', '_', os.path.basename(url_name))
        cache_file = os.path.join(cache_dir, url_md5 + '_' + safe_name)
        temp_file = os.path.join(
            cache_dir, 'tmp_' + os.urandom(8).hex() + '_' + url_md5)
        os.makedirs(cache_dir, exist_ok=True)
        with open(temp_file, 'wb') as f:
            f.write(url_data)
        os.replace(temp_file, cache_file)  # atomic
        if return_filename:
            return cache_file
    return io.BytesIO(url_data)


def resolve_resume(resume: Optional[str],
                   cache_dir: Optional[str] = None,
                   verbose: bool = True,
                   fetch: bool = True) -> Tuple[Optional[str], str]:
    """Resolve a --resume value to a LOCAL file path + run-desc suffix
    (reference: train_aio.py:341-351).

    ``resume`` may be None/'noresume', a predefined alias (RESUME_SPECS),
    a local path, or a URL; aliases and URLs are fetched through the
    caching opener.  Returns ``(local_path_or_None, desc_suffix)``.
    ``fetch=False`` resolves the desc suffix only (dry-run; no download) —
    the returned path is then the alias URL / original string.
    """
    assert resume is None or isinstance(resume, str)
    if resume is None or resume == 'noresume':
        return None, ('-noresume' if resume == 'noresume' else '')
    if resume in RESUME_SPECS:
        url = RESUME_SPECS[resume]
        path = (open_url(url, cache_dir=cache_dir, return_filename=True,
                         verbose=verbose) if fetch else url)
        return path, f'-resume{resume}'
    if is_url(resume) or resume.startswith('file://'):
        path = (open_url(resume, cache_dir=cache_dir, return_filename=True,
                         verbose=verbose) if fetch else resume)
        return path, '-resumecustom'
    return resume, '-resumecustom'  # local path (snapshot dir/file)
