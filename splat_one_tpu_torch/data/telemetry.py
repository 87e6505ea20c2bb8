"""Video-embedded telemetry: CAMM and GoPro GPMF geotag tracks (the port's
copy of ``splat_one_tpu/data/telemetry.py``; stdlib only).

Replaces the reference's mapillary_tools video geotag sources
``--geotag_source camm / gopro_videos`` (reference surface:
app/main_app.py:248-264, VideoProcessCommand geotag_source): a minimal
ISO-BMFF (MP4) demuxer locates the metadata track and its samples, and the
two payload parsers decode GPS fixes into the same ``[{time_s, lat, lon,
alt}]`` track format as ``data.video.parse_gpx`` (time_s is
video-relative — the sample's presentation time — so frames extracted at
``i * interval_s`` interpolate directly).

- CAMM (Android Camera Motion Metadata): little-endian samples of
  ``u16 reserved, u16 type``; type 5 = position (3 doubles lat/lon/alt),
  type 6 = full GPS (time, fix, lat/lon doubles, alt float, accuracies,
  velocities). Sample entry fourcc ``camm``.
- GPMF (GoPro metadata): big-endian KLV (fourcc, type, struct size,
  repeat); ``GPS5`` rows (lat, lon, alt, speed2d, speed3d as s32) scaled
  by the stream's ``SCAL`` divisors. Sample entry fourcc ``gpmd``; rows
  within one packet spread evenly across the sample's duration.
- BlackVue: NMEA sentences with bracketed epoch-ms prefixes inside the
  MP4's top-level ``free`` boxes (``parse_blackvue_bytes``).
- exiftool RDF/XML sidecars (``parse_exiftool_xml``) for the
  ``exiftool_xml`` source: Track*/QuickTime timed GPS tags, DMS or
  decimal coordinates.

Pure stdlib struct parsing — no ffmpeg/av dependency; only the box types
needed for sample extraction are implemented (stsd/stts/stsc/stsz/stco/
co64, 64-bit largesize boxes included).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional


_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
               b"udta"}


def _boxes(buf: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_end) for boxes in a range."""
    off = start
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, off)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            break
        yield typ, off + hdr, off + size
        off += size


def _find(buf, start, end, path):
    """First box at a nested fourcc path; returns (pstart, pend)."""
    if not path:
        return start, end
    for typ, ps, pe in _boxes(buf, start, end):
        if typ == path[0]:
            return _find(buf, ps, pe, path[1:])
    return None


def _find_all(buf, start, end, fourcc):
    return [(ps, pe) for typ, ps, pe in _boxes(buf, start, end)
            if typ == fourcc]


def mp4_metadata_samples(data: bytes, entry_fourcc: bytes):
    """Samples of the first track whose stsd entry is ``entry_fourcc``:
    [(offset, size, t_s, dur_s)] with presentation times in seconds."""
    moov = _find(data, 0, len(data), [b"moov"])
    if moov is None:
        return []
    for tps, tpe in _find_all(data, moov[0], moov[1], b"trak"):
        mdia = _find(data, tps, tpe, [b"mdia"])
        if mdia is None:
            continue
        stbl = _find(data, mdia[0], mdia[1], [b"minf", b"stbl"])
        mdhd = _find(data, mdia[0], mdia[1], [b"mdhd"])
        if stbl is None or mdhd is None:
            continue
        ver = data[mdhd[0]]
        timescale = struct.unpack_from(
            ">I", data, mdhd[0] + (20 if ver == 1 else 12))[0]
        stsd = _find(data, stbl[0], stbl[1], [b"stsd"])
        if stsd is None:
            continue
        n_entries = struct.unpack_from(">I", data, stsd[0] + 4)[0]
        off = stsd[0] + 8
        fmt = None
        for _ in range(n_entries):
            esize, efmt = struct.unpack_from(">I4s", data, off)
            fmt = efmt
            break  # first entry decides the track type
        if fmt != entry_fourcc:
            continue

        def table(cc):
            box = _find(data, stbl[0], stbl[1], [cc])
            return box

        # sample sizes
        stsz = table(b"stsz")
        const_size, n_samples = struct.unpack_from(
            ">II", data, stsz[0] + 4)
        if const_size:
            sizes = [const_size] * n_samples
        else:
            sizes = list(struct.unpack_from(
                f">{n_samples}I", data, stsz[0] + 12))
        # chunk offsets
        stco = table(b"stco")
        if stco is not None:
            n_chunks = struct.unpack_from(">I", data, stco[0] + 4)[0]
            chunk_offs = list(struct.unpack_from(
                f">{n_chunks}I", data, stco[0] + 8))
        else:
            co64 = table(b"co64")
            n_chunks = struct.unpack_from(">I", data, co64[0] + 4)[0]
            chunk_offs = list(struct.unpack_from(
                f">{n_chunks}Q", data, co64[0] + 8))
        # samples per chunk
        stsc = table(b"stsc")
        n_stsc = struct.unpack_from(">I", data, stsc[0] + 4)[0]
        stsc_rows = [
            struct.unpack_from(">III", data, stsc[0] + 8 + 12 * i)
            for i in range(n_stsc)
        ]
        # per-sample durations
        stts = table(b"stts")
        n_stts = struct.unpack_from(">I", data, stts[0] + 4)[0]
        durs: List[int] = []
        for i in range(n_stts):
            cnt, delta = struct.unpack_from(
                ">II", data, stts[0] + 8 + 8 * i)
            durs += [delta] * cnt
        durs += [durs[-1] if durs else 1] * (n_samples - len(durs))

        samples = []
        si = 0
        t = 0
        for ci, coff in enumerate(chunk_offs):
            spc = 1
            for first, cnt, _ in stsc_rows:
                if ci + 1 >= first:
                    spc = cnt
            off_in = coff
            for _ in range(spc):
                if si >= n_samples:
                    break
                samples.append((off_in, sizes[si], t / timescale,
                                durs[si] / timescale))
                off_in += sizes[si]
                t += durs[si]
                si += 1
        return samples
    return []


def parse_camm_bytes(data: bytes) -> List[Dict]:
    """CAMM GPS track (types 5/6) -> [{time_s, lat, lon, alt}]."""
    out = []
    for off, size, t_s, _dur in mp4_metadata_samples(data, b"camm"):
        if size < 4:
            continue
        _res, typ = struct.unpack_from("<HH", data, off)
        p = off + 4
        if typ == 5 and size >= 4 + 24:
            lat, lon, alt = struct.unpack_from("<ddd", data, p)
            out.append(dict(time_s=t_s, lat=lat, lon=lon, alt=alt))
        elif typ == 6 and size >= 4 + 8 + 4 + 8 + 8 + 4:
            (_t_gps, _fix, lat, lon, alt) = struct.unpack_from(
                "<diddf", data, p)
            out.append(dict(time_s=t_s, lat=lat, lon=lon, alt=alt))
    return sorted(out, key=lambda r: r["time_s"])


def _gpmf_klv(data: bytes, start: int, end: int):
    """Yield (fourcc, type, struct_size, repeat, payload_off) KLV items."""
    off = start
    while off + 8 <= end:
        cc = data[off:off + 4]
        typ = data[off + 4]
        ssz = data[off + 5]
        rep = struct.unpack_from(">H", data, off + 6)[0]
        plen = ssz * rep
        yield cc, typ, ssz, rep, off + 8
        off += 8 + ((plen + 3) & ~3)


def parse_gpmf_payload(data: bytes, start: int, end: int,
                       t0: float, dur: float) -> List[Dict]:
    """One gpmd sample payload -> GPS rows (GPS5 scaled by SCAL)."""
    rows: List[Dict] = []
    scal: Optional[List[int]] = None
    gps5: List[tuple] = []
    for cc, typ, ssz, rep, poff in _gpmf_klv(data, start, end):
        if typ == 0:  # nested container (DEVC / STRM)
            rows += parse_gpmf_payload(data, poff, poff + ssz * rep,
                                       t0, dur)
        elif cc == b"SCAL":
            n = (ssz * rep) // 4
            scal = list(struct.unpack_from(f">{n}i", data, poff))
        elif cc == b"GPS5" and ssz == 20:
            for i in range(rep):
                gps5.append(struct.unpack_from(">5i", data, poff + 20 * i))
    if gps5:
        s = scal or [1] * 5
        n = len(gps5)
        for i, (lat, lon, alt, _s2, _s3) in enumerate(gps5):
            rows.append(dict(
                time_s=t0 + dur * i / max(n, 1),
                lat=lat / s[0], lon=lon / s[1], alt=alt / s[2],
            ))
    return rows


def parse_gpmf_bytes(data: bytes) -> List[Dict]:
    """GoPro GPMF GPS track -> [{time_s, lat, lon, alt}]."""
    out: List[Dict] = []
    for off, size, t_s, dur in mp4_metadata_samples(data, b"gpmd"):
        out += parse_gpmf_payload(data, off, off + size, t_s, dur)
    return sorted(out, key=lambda r: r["time_s"])


def _nmea_deg(v: str, hemi: str) -> float:
    f = float(v)
    d = int(f / 100)
    out = d + (f - d * 100) / 60.0
    return -out if hemi in ("S", "W") else out


def parse_blackvue_bytes(data) -> List[Dict]:
    """BlackVue dashcam GPS track -> [{time_s, lat, lon, alt}].

    BlackVue MP4s embed NMEA sentences in top-level ``free`` boxes, each
    line prefixed with a bracketed epoch-milliseconds timestamp:
    ``[1623057074211]$GPRMC,...`` (the reference's mapillary_tools
    ``--geotag_source blackvue``, app/main_app.py:248-264). The bracket
    epoch provides the clock; RMC provides position, GGA altitude.
    Returned times are VIDEO-RELATIVE (first fix = 0) to match the other
    embedded sources."""
    import re

    rows = []
    alts = {}
    n = len(data)
    free_ranges = [(ps, pe) for typ, ps, pe in _boxes(data, 0, n)
                   if typ == b"free"]
    pat = re.compile(rb"\[(\d{10,16})\](\$[A-Z]{2}(?:RMC|GGA)[^\r\n]*)")
    for ps, pe in free_ranges:
        for m in pat.finditer(bytes(data[ps:pe])):
            t_ms = int(m.group(1))
            body = m.group(2).split(b"*")[0].decode("ascii", "ignore")
            p = body.split(",")
            typ = p[0][3:]
            try:
                if typ == "GGA" and len(p) > 9 and p[9]:
                    alts[t_ms // 1000] = float(p[9])
                elif typ == "RMC" and len(p) > 6 and p[2] == "A":
                    rows.append(dict(
                        time_s=t_ms / 1000.0,
                        lat=_nmea_deg(p[3], p[4]),
                        lon=_nmea_deg(p[5], p[6]),
                        alt=0.0,
                    ))
            except (ValueError, IndexError):
                continue  # malformed sentence: skip
    for r in rows:
        r["alt"] = alts.get(int(r["time_s"]), 0.0)
    rows.sort(key=lambda r: r["time_s"])
    if rows:
        t0 = rows[0]["time_s"]
        for r in rows:
            r["time_s"] -= t0
    return rows


def parse_exiftool_xml(xml_path: str) -> List[Dict]:
    """exiftool -X (RDF/XML) sidecar -> [{time_s, lat, lon, alt}].

    The reference's ``--geotag_source exiftool_xml`` consumes exiftool's
    RDF dump of a video's timed GPS track (Track*/QuickTime GPS tags).
    Handles decimal or DMS-formatted coordinates and groups repeated
    latitude/longitude/altitude/timestamp tags in document order into
    samples. Times are video-relative (first fix = 0)."""
    import re
    import xml.etree.ElementTree as ET

    def to_deg(s: str) -> float:
        s = s.strip()
        m = re.match(
            r"(\d+(?:\.\d+)?) deg (\d+(?:\.\d+)?)' "
            r"(\d+(?:\.\d+)?)\" ([NSEW])", s)
        if m:
            v = (float(m.group(1)) + float(m.group(2)) / 60
                 + float(m.group(3)) / 3600)
            return -v if m.group(4) in "SW" else v
        # decimal, possibly with hemisphere suffix
        m = re.match(r"(-?\d+(?:\.\d+)?)\s*([NSEW])?", s)
        v = float(m.group(1))
        return -v if m.group(2) in ("S", "W") else v

    def to_time(s: str):
        import datetime as dt

        m = re.match(
            r"(\d{4}):(\d{2}):(\d{2})[ T](\d{2}):(\d{2}):"
            r"(\d{2}(?:\.\d+)?)", s.strip())
        if not m:
            return None
        sec = float(m.group(6))
        return dt.datetime(
            int(m.group(1)), int(m.group(2)), int(m.group(3)),
            int(m.group(4)), int(m.group(5)), int(sec),
            int((sec % 1) * 1e6), tzinfo=dt.timezone.utc).timestamp()

    root = ET.parse(xml_path).getroot()
    samples: List[Dict] = []
    cur: Dict = {}

    def flush():
        nonlocal cur
        if "lat" in cur and "lon" in cur:
            samples.append(cur)
        cur = {}

    def put(key, value):
        # tags repeat per sample in document order: a repeated field
        # means the previous sample is complete
        if key in cur:
            flush()
        cur[key] = value

    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        txt = (el.text or "").strip()
        if not txt:
            continue
        try:
            if tag == "GPSCoordinates":
                parts = txt.split(",")
                put("lat", to_deg(parts[0]))
                cur["lon"] = to_deg(parts[1])
                if len(parts) > 2:
                    cur["alt"] = float(re.sub(r"[^\d.+-]", "",
                                              parts[2]) or 0)
                flush()
            elif tag == "GPSLatitude":
                put("lat", to_deg(txt))
            elif tag == "GPSLongitude":
                put("lon", to_deg(txt))
            elif tag == "GPSAltitude":
                put("alt", float(re.sub(r"[^\d.+-]", "", txt) or 0))
            elif tag == "SampleTime":
                m = re.match(r"(?:(\d+):)?(\d+):(\d+(?:\.\d+)?)"
                             r"|(\d+(?:\.\d+)?) s", txt)
                if m:
                    if m.group(4) is not None:
                        put("time_s", float(m.group(4)))
                    else:
                        put("time_s", 3600 * int(m.group(1) or 0)
                            + 60 * int(m.group(2)) + float(m.group(3)))
            elif tag == "GPSDateTime":
                t = to_time(txt)
                if t is not None:
                    put("time_s", t)
        except (ValueError, AttributeError, IndexError):
            continue
    flush()
    out = []
    for i, s in enumerate(samples):
        if "lat" not in s or "lon" not in s:
            continue
        out.append(dict(
            time_s=float(s.get("time_s", i)),
            lat=s["lat"], lon=s["lon"], alt=float(s.get("alt", 0.0))))
    out.sort(key=lambda r: r["time_s"])
    if out and out[0]["time_s"] > 1e6:  # absolute clock -> video-relative
        t0 = out[0]["time_s"]
        for r in out:
            r["time_s"] -= t0
    return out


def parse_video_geotags(video_path: str, source: str = "auto"
                        ) -> List[Dict]:
    """Extract the embedded GPS track from an MP4 (source: "camm",
    "gopro", or "auto" = try camm then gpmf).

    The file is memory-mapped, not read: capture videos are multi-GB but
    the parsers only touch the moov box tables and the located metadata
    sample ranges, so the OS pages in a few hundred KB."""
    import mmap
    import os

    if os.path.getsize(video_path) == 0:
        return []
    with open(video_path, "rb") as fh:
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as data:
            if source in ("camm", "auto"):
                track = parse_camm_bytes(data)
                if track or source == "camm":
                    return track
            if source in ("gopro", "gopro_videos", "auto"):
                track = parse_gpmf_bytes(data)
                if track or source != "auto":
                    return track
            return parse_blackvue_bytes(data)
