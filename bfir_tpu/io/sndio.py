"""Any-format sound file reading: the libsndfile-equivalent front door.

The reference loads impulse files through libsndfile's sf_wchar_open, which
accepts any format the library was built with (/root/reference/brutefir/
buffer.cpp:37-139). This module dispatches on the file's magic bytes:

- RIFF/WAVE  -> io.wavio (own parser; PCM u8..s32, f32/f64, EXTENSIBLE,
               plus the RF64 and Sonic Foundry W64 64-bit WAV framings)
- fLaC       -> io.flacio (own pure-python decoder, CRC+MD5 verified)
- FORM/AIFF  -> io.aiffio (PCM BE/LE, AIFF-C float32/64)
- .snd (AU)  -> io.auio (PCM/float/mu-law/a-law)
- caff (CAF) -> io.cafio (linear PCM/float)
- anything else -> optional ``soundfile`` if installed, otherwise a clear
  error NAMING the detected format.

Writing stays WAV (the reference writes only WAV caches, buffer.cpp:96-139)
plus FLAC via flacio.write_flac.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

# Detected-but-not-natively-decoded containers. Covers every libsndfile
# major format ID (/root/reference/libsndfile/sndfile.h:48-73) that has a
# recognizable magic and is not decoded natively here, plus common lossy
# codecs libsndfile itself rejects — so an unsupported impulse file always
# produces an error NAMING its format, never a silent failure
# Ordered dict: first prefix match wins.
_MAGIC_NAMES = {
    b"OggS": "Ogg (Vorbis/Opus)",                 # SF_FORMAT_OGG
    b"ID3": "MP3 (ID3)",
    b"\xff\xfb": "MP3",
    b"\xff\xf1": "AAC (ADTS)",
    b"\xff\xf9": "AAC (ADTS)",
    b"MAC ": "Monkey's Audio (APE)",
    b"wvpk": "WavPack",
    b" paf": "Ensoniq PARIS (PAF)",               # SF_FORMAT_PAF big-endian
    b"fap ": "Ensoniq PARIS (PAF)",               # PAF little-endian
    b"NIST_1A": "Sphere NIST",                    # SF_FORMAT_NIST
    b"Creative Voice File": "Creative VOC",       # SF_FORMAT_VOC
    b"\x64\xa3": "Berkeley/IRCAM/CARL",           # SF_FORMAT_IRCAM (BE)
    b"\x01\xa3": "Berkeley/IRCAM/CARL",
    b"\x03\xa3": "Berkeley/IRCAM/CARL",
    b"\x04\xa3": "Berkeley/IRCAM/CARL",
    b"MATLAB 5.0 MAT-file": "Matlab MAT5",        # SF_FORMAT_MAT5
    b"PVF1": "Portable Voice Format",             # SF_FORMAT_PVF
    b"Extended Instrument: ": "Fasttracker 2 XI", # SF_FORMAT_XI
    b"\xf0\x7e": "MIDI Sample Dump (SDS)",        # SF_FORMAT_SDS
    b"2BIT": "Audio Visual Research (AVR)",       # SF_FORMAT_AVR
    b"Sd2f": "Sound Designer 2",                  # SF_FORMAT_SD2
    b"ALawSoundFile**": "Psion WVE",              # SF_FORMAT_WVE
}
# (SF_FORMAT_RAW / MAT4 / HTK / MPC2K are headerless or magic-less: they
# fall to 'unknown', still a named error. WAVEX, RF64 and W64 read
# natively via wavio; SVX is caught by the FORM branch below.)


class SndInfo(NamedTuple):
    n_channels: int
    sample_rate: int
    n_frames: int
    format: str


def _sniff(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"RF64" and head[8:12] == b"WAVE":
        return "wav"  # EBU 64-bit WAV (wavio._parse_chunks_rf64)
    if head[:4] == b"riff" and head[8:12] == b"\xa5\xd6\x28\xdb":
        return "wav"  # Sonic Foundry W64 GUID (wavio._parse_chunks_w64)
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"FORM":
        if head[8:12] in (b"AIFF", b"AIFC"):
            return "aiff"
        if head[8:12] in (b"8SVX", b"16SV"):  # SF_FORMAT_SVX
            return "unsupported:Amiga IFF/SVX"
    if head[:4] == b".snd":
        return "au"
    if head[:4] == b"caff":
        return "caf"
    for magic, name in _MAGIC_NAMES.items():
        if head.startswith(magic):
            return f"unsupported:{name}"
    return "unsupported:unknown"


def _unsupported(path: str, kind: str):
    name = kind.split(":", 1)[1]
    try:  # an installed soundfile widens coverage; absent on this image
        import soundfile  # noqa: F401

        return soundfile
    except ImportError:
        raise ValueError(
            f"unsupported sound file format '{name}' for {path!r}: this build "
            "reads WAV, FLAC, AIFF/AIFF-C, AU and CAF natively (install "
            "'soundfile' for other formats)"
        ) from None


def read(path: str) -> Tuple[np.ndarray, int]:
    """-> (audio float64 [frames, channels], sample_rate)."""
    kind = _sniff(path)
    if kind == "wav":
        from bfir_tpu.io import wavio

        return wavio.read(path)
    if kind == "flac":
        from bfir_tpu.io import flacio

        return flacio.read_flac(path)
    if kind == "aiff":
        from bfir_tpu.io import aiffio

        return aiffio.read(path)
    if kind == "au":
        from bfir_tpu.io import auio

        return auio.read(path)
    if kind == "caf":
        from bfir_tpu.io import cafio

        return cafio.read(path)
    if kind.endswith("Ogg (Vorbis/Opus)"):
        # SF_FORMAT_OGG: decode via the system libvorbis, exactly the
        # delegation the reference's libsndfile performs (ogg_vorbis.c ->
        # vorbisfile); the soundfile fallback below covers Opus-in-Ogg or
        # a libvorbis-less host (io/oggvorbis.py)
        from bfir_tpu.io import oggvorbis

        if oggvorbis.available():
            try:
                return oggvorbis.read_vorbis(path)
            except ValueError:
                pass  # Ogg but not Vorbis (e.g. Opus): try soundfile
    sf = _unsupported(path, kind)
    audio, rate = sf.read(path, dtype="float64", always_2d=True)
    return audio, rate


def read_info(path: str) -> SndInfo:
    kind = _sniff(path)
    if kind == "wav":
        from bfir_tpu.io import wavio

        info = wavio.read_info(path)
        return SndInfo(info.n_channels, info.sample_rate, info.n_frames, "wav")
    if kind == "flac":
        from bfir_tpu.io import flacio

        si = flacio.read_flac_info(path)
        return SndInfo(si.channels, si.rate, si.total_samples, "flac")
    if kind == "aiff":
        from bfir_tpu.io import aiffio

        ch, rate, frames, comp = aiffio.read_info(path)
        return SndInfo(ch, rate, frames, f"aiff/{comp.strip() or 'NONE'}")
    if kind == "au":
        from bfir_tpu.io import auio

        i = auio.read_info(path)
        return SndInfo(i.n_channels, i.sample_rate, i.n_frames, f"au/{i.encoding}")
    if kind == "caf":
        from bfir_tpu.io import cafio

        i = cafio.read_info(path)
        return SndInfo(i.n_channels, i.sample_rate, i.n_frames, f"caf/{i.encoding}")
    if kind.endswith("Ogg (Vorbis/Opus)"):
        from bfir_tpu.io import oggvorbis

        if oggvorbis.available():
            try:
                audio, rate = oggvorbis.read_vorbis(path)
                return SndInfo(audio.shape[1], rate, audio.shape[0],
                               "ogg/vorbis")
            except ValueError:
                pass
    sf = _unsupported(path, kind)
    i = sf.info(path)
    return SndInfo(i.channels, i.samplerate, i.frames, i.format.lower())
