"""Dataset video acquisition CLI (youtube crawler).

Reference behavior: datasets/download.py (ActivityNet-crawler
derivative: annotation-JSON keys are 11-char youtube ids, each fetched
as <id>.mp4 via youtube-dl with retries, in parallel, with a
download_report.json) and datasets/download_finegym.sh (the FineGym
annotation/video driver). This is an original implementation: a
ThreadPoolExecutor replaces joblib (the work is IO-bound), the
downloader binary is pluggable (yt-dlp default, youtube-dl
compatible), and already-present files short-circuit as 'Exists' just
like the reference's idempotence guard (download.py:63-67).

CLI:
  python -m opental_torch.tools.download <annotation.json|ids.txt> \
      <out_dir> [-n jobs] [--downloader yt-dlp] [--attempts 5] \
      [--report download_report.json]

Copy of `opental_tpu/tools/download.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

URL_BASE = 'https://www.youtube.com/watch?v='


def read_video_ids(path: str) -> List[str]:
    """Annotation JSON (top-level id->anno dict, or an ActivityNet-style
    {'database': {id: ...}}) or a plain one-id-per-line txt."""
    if path.endswith('.json'):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and isinstance(data.get('database'),
                                                 dict):
            data = data['database']
        return list(data.keys())
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def download_one(video_id: str, out_dir: str, downloader: str = 'yt-dlp',
                 attempts: int = 5, url_base: str = URL_BASE
                 ) -> Tuple[str, bool, str]:
    """Fetch one video as <out_dir>/<id>.mp4; returns
    (id, ok, 'Exists'|'Downloaded'|'Fail') like download.py:60-70."""
    out = os.path.join(out_dir, video_id + '.mp4')
    if os.path.exists(out):
        return video_id, True, 'Exists'
    cmd = [downloader, '--quiet', '--no-warnings',
           '--no-check-certificate', '-f', 'mp4', '-o', out,
           url_base + video_id]
    for _ in range(attempts):
        try:
            subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.STDOUT)
            break
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
    ok = os.path.exists(out)
    return video_id, ok, 'Downloaded' if ok else 'Fail'


def download_all(ids: List[str], out_dir: str, jobs: int = 8,
                 downloader: str = 'yt-dlp', attempts: int = 5,
                 url_base: str = URL_BASE) -> List[Tuple[str, bool, str]]:
    os.makedirs(out_dir, exist_ok=True)
    if jobs <= 1:
        return [download_one(v, out_dir, downloader, attempts, url_base)
                for v in ids]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(
            lambda v: download_one(v, out_dir, downloader, attempts,
                                   url_base), ids))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description='Download youtube videos named by an annotation '
                    'file (FineGym/ActivityNet schema) or an id list.')
    p.add_argument('input')
    p.add_argument('output_dir')
    p.add_argument('-n', '--num-jobs', type=int, default=8)
    p.add_argument('--downloader', default='yt-dlp')
    p.add_argument('--attempts', type=int, default=5)
    p.add_argument('--url_base', default=URL_BASE)
    p.add_argument('--report', default='download_report.json')
    args = p.parse_args(argv)

    ids = read_video_ids(args.input)
    status = download_all(ids, args.output_dir, args.num_jobs,
                          args.downloader, args.attempts, args.url_base)
    with open(args.report, 'w') as f:
        json.dump([list(s) for s in status], f, indent=1)
    done = sum(1 for _, ok, _ in status if ok)
    print(f'{done}/{len(status)} videos present; report -> {args.report}')


if __name__ == '__main__':
    main()
