"""Dataset download helpers.

Reference: datasets/download.py + download_finegym.sh (youtube fetches
for ActivityNet/FineGym videos). Downloads require network egress and an
installed yt-dlp/youtube-dl binary; this module shells out to whichever
is present and degrades with a clear error otherwise.

Copy of `opental_tpu/data/download.py`.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence


def _downloader() -> List[str]:
    for cand in ('yt-dlp', 'youtube-dl'):
        if shutil.which(cand):
            return [cand]
    raise RuntimeError(
        'no yt-dlp/youtube-dl binary found — install one to download '
        'videos (offline preprocessing of existing mp4s does not need it)')


def download_video(video_id: str, out_dir: str,
                   fmt: str = 'mp4') -> Optional[str]:
    """Fetch one youtube video by id into out_dir; returns the path or
    None on failure (missing/private videos are common in ANet)."""
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f'v_{video_id}.{fmt}')
    if os.path.exists(out_path):
        return out_path
    cmd = _downloader() + [
        f'https://www.youtube.com/watch?v={video_id}',
        '-f', f'best[ext={fmt}]', '-o', out_path, '--no-progress']
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        return out_path
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None


def download_activitynet(anno_json: str, out_dir: str,
                         subsets: Sequence[str] = ('training',
                                                   'validation'),
                         max_videos: Optional[int] = None
                         ) -> Dict[str, int]:
    """Fetch the ActivityNet videos listed in an annotation JSON."""
    with open(anno_json) as f:
        database = json.load(f)['database']
    stats = {'ok': 0, 'failed': 0, 'skipped': 0}
    count = 0
    for vid, info in database.items():
        if info.get('subset') not in subsets:
            stats['skipped'] += 1
            continue
        if max_videos is not None and count >= max_videos:
            break
        count += 1
        if download_video(vid, out_dir):
            stats['ok'] += 1
        else:
            stats['failed'] += 1
    return stats
