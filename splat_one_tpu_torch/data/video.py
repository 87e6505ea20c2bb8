"""Video -> frames + geotag ingestion: the port's copy of
``splat_one_tpu/data/video.py`` (stdlib only; no tensor).

Frame extraction shells out to ffmpeg and raises where there is no
``ffmpeg`` binary; GPX / NMEA / exiftool-XML parsing and the time
interpolation of geotags are pure Python, writing the
``image_descriptions.json`` that ``ImageProcessor.apply_image_descriptions``
injects into the workdir's exif JSONs (the reference's mapillary_tools
``video_process`` flow).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(
    video_path: str,
    out_dir: str,
    interval_s: float = 2.0,
    prefix: Optional[str] = None,
) -> List[str]:
    """Sample frames every ``interval_s`` seconds with ffmpeg."""
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg not found — video ingestion requires an ffmpeg binary"
        )
    os.makedirs(out_dir, exist_ok=True)
    prefix = prefix or os.path.splitext(os.path.basename(video_path))[0]
    pattern = os.path.join(out_dir, f"{prefix}_%06d.jpg")
    subprocess.run(
        [
            "ffmpeg", "-y", "-i", video_path,
            "-vf", f"fps=1/{interval_s}", "-qscale:v", "2", pattern,
        ],
        check=True, capture_output=True,
    )
    return sorted(
        f for f in os.listdir(out_dir) if f.startswith(prefix)
    )


def parse_gpx(gpx_path: str) -> List[Dict]:
    """GPX track points -> [{time_s, lat, lon, alt}] sorted by time."""
    ns = {"g": "http://www.topografix.com/GPX/1/1"}
    root = ET.parse(gpx_path).getroot()
    import datetime as dt

    pts = []
    for trkpt in root.iter("{http://www.topografix.com/GPX/1/1}trkpt"):
        lat = float(trkpt.get("lat"))
        lon = float(trkpt.get("lon"))
        ele = trkpt.find("g:ele", ns)
        t = trkpt.find("g:time", ns)
        if t is None:
            continue
        ts = dt.datetime.fromisoformat(
            t.text.replace("Z", "+00:00")
        ).timestamp()
        pts.append(
            {
                "time_s": ts,
                "lat": lat,
                "lon": lon,
                "alt": float(ele.text) if ele is not None else 0.0,
            }
        )
    return sorted(pts, key=lambda p: p["time_s"])


def parse_nmea(nmea_path: str) -> List[Dict]:
    """NMEA-0183 log -> [{time_s, lat, lon, alt}] sorted by time (the
    reference's ``--geotag_source nmea`` via mapillary_tools,
    app/main_app.py:248-264).

    Reads $G?RMC sentences for date+time+position and $G?GGA for
    altitude (matched by time-of-day). Positions are ddmm.mmmm with
    N/S/E/W hemisphere letters."""
    import datetime as dt

    def _deg(v: str, hemi: str) -> float:
        f = float(v)
        d = int(f / 100)
        m = f - d * 100
        out = d + m / 60.0
        return -out if hemi in ("S", "W") else out

    def _tkey(t: str) -> str:
        # GGA/RMC decimal precision differs per receiver ("123519" vs
        # "123519.00"): match at whole-second resolution
        return t.split(".")[0]

    alts = {}  # hhmmss -> altitude (from GGA)
    rows = []
    with open(nmea_path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("$"):
                continue
            body = line.split("*")[0]
            p = body.split(",")
            typ = p[0][3:]
            try:
                if typ == "GGA" and len(p) > 9 and p[9]:
                    alts[_tkey(p[1])] = float(p[9])
                elif typ == "RMC" and len(p) > 9 and p[2] == "A":
                    t, d = p[1], p[9]
                    ts = dt.datetime(
                        2000 + int(d[4:6]), int(d[2:4]), int(d[0:2]),
                        int(t[0:2]), int(t[2:4]), int(float(t[4:])),
                        int((float(t[4:]) % 1) * 1e6),
                        tzinfo=dt.timezone.utc,
                    ).timestamp()
                    rows.append({
                        "time_s": ts,
                        "lat": _deg(p[3], p[4]),
                        "lon": _deg(p[5], p[6]),
                        "alt": alts.get(_tkey(t), 0.0),
                    })
            except (ValueError, IndexError):
                continue  # malformed sentence: skip (real logs have them)
    return sorted(rows, key=lambda r: r["time_s"])


def parse_geotag_file(path: str) -> List[Dict]:
    """Dispatch on geotag source format: .gpx, exiftool RDF/XML dumps
    (.xml — the reference's ``exiftool_xml`` source), or NMEA text logs
    (.nmea/.log/.txt)."""
    low = path.lower()
    if low.endswith(".gpx"):
        return parse_gpx(path)
    if low.endswith(".xml"):
        from splat_one_tpu_torch.data.telemetry import parse_exiftool_xml

        return parse_exiftool_xml(path)
    return parse_nmea(path)


def interpolate_geotags(
    frame_names: List[str],
    frame_times_s: List[float],
    track: List[Dict],
) -> List[Dict]:
    """Linear-interpolate the GPS track at each frame time; returns
    mapillary-style image descriptions consumed by
    ``ImageProcessor.apply_image_descriptions``."""
    import bisect
    import datetime as dt

    times = [p["time_s"] for p in track]
    out = []
    for name, t in zip(frame_names, frame_times_s):
        i = bisect.bisect_left(times, t)
        if i <= 0:
            p = track[0]
            lat, lon, alt = p["lat"], p["lon"], p["alt"]
        elif i >= len(track):
            p = track[-1]
            lat, lon, alt = p["lat"], p["lon"], p["alt"]
        else:
            a, b = track[i - 1], track[i]
            f = (t - a["time_s"]) / max(b["time_s"] - a["time_s"], 1e-9)
            lat = a["lat"] + f * (b["lat"] - a["lat"])
            lon = a["lon"] + f * (b["lon"] - a["lon"])
            alt = a["alt"] + f * (b["alt"] - a["alt"])
        out.append(
            {
                "filename": name,
                "MAPLatitude": lat,
                "MAPLongitude": lon,
                "MAPAltitude": alt,
                "MAPCaptureTime": dt.datetime.fromtimestamp(
                    t, dt.timezone.utc
                ).strftime("%Y_%m_%d_%H_%M_%S_%f")[:-3],
            }
        )
    return out


def process_video(
    video_path: str,
    workdir: str,
    interval_s: float = 2.0,
    gpx_path: Optional[str] = None,
    geotag_source: str = "file",
) -> int:
    """Full ingestion: frames into <workdir>/images plus
    image_descriptions.json geotags (the reference's process_video flow,
    main_app.py:216-277). ``geotag_source``: "file" (GPX / NMEA /
    exiftool-XML sidecar at ``gpx_path``) or "camm"/"gopro"/"blackvue"/
    "auto" (telemetry embedded in the video itself, data.telemetry) —
    the reference's full source menu (main_app.py:57-63)."""
    frames = extract_frames(
        video_path, os.path.join(workdir, "images"), interval_s
    )
    if geotag_source != "file":
        from splat_one_tpu_torch.data.telemetry import parse_video_geotags

        track = parse_video_geotags(video_path, geotag_source)
        if track:
            # embedded tracks are video-relative: frame i sits at
            # i * interval_s on the same clock
            times = [i * interval_s for i in range(len(frames))]
            desc = interpolate_geotags(frames, times, track)
            desc_path = os.path.join(workdir, "image_descriptions.json")
            with open(desc_path, "w") as f:
                json.dump(desc, f, indent=2)
            from splat_one_tpu_torch.app.image_processing import ImageProcessor

            ImageProcessor(workdir).apply_image_descriptions(desc_path)
        return len(frames)
    if gpx_path:
        track = parse_geotag_file(gpx_path)
        times = [
            track[0]["time_s"] + i * interval_s for i in range(len(frames))
        ]
        desc = interpolate_geotags(frames, times, track)
        desc_path = os.path.join(workdir, "image_descriptions.json")
        with open(desc_path, "w") as f:
            json.dump(desc, f, indent=2)
        from splat_one_tpu_torch.app.image_processing import ImageProcessor

        ImageProcessor(workdir).apply_image_descriptions(desc_path)
    return len(frames)
