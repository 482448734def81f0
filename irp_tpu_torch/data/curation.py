"""Dataset curation: ingest, analysis, rule-based cleaning, standardization,
split + shard creation, verification.

Behavioral rebuild of the reference curation suite (reference
functions/data_curation.py):

- ``prepare_animal_dataset`` — Kaggle Animals-10 ingest, Italian->English
  folder translation (data_curation.py:1132-1243, dict :1147-1158)
- ``analyze_dataset`` — one decoding pass per image: size thresholds
  224/128/64/32, aspect-ratio stats/categories, channel distribution,
  MD5-of-64x64-RGB duplicate hashing, corrupt detection
  (data_curation.py:294-486, hash :283-292)
- ``write_analysis_report`` — plain-text mirror of the report (the
  reference commits ``dataset_analysis_report.txt`` as a golden artifact);
  ``display_dataset_report`` prints it and returns its pandas tables
  (with a sample-image grid), ``render_analysis_markdown`` renders it as
  Markdown with the reference's section headers
- ``clean_image_dataset`` — copy-filter excluding grayscale / RGBA /
  below-min-resolution / duplicates; writes
  ``dataset_cleaning_report.txt`` (data_curation.py:488-635)
- ``resize_and_crop_image`` — RGBA->RGB white-composite, short-side LANCZOS
  resize, center crop (data_curation.py:886-915)
- ``create_balanced_test_set`` — min_class_count * test_size samples PER
  CLASS to test, rest to train, both shuffled (data_curation.py:917-966)
- ``process_dataset`` — split + standardize + WebDataset shard write with
  the reference sample schema (data_curation.py:968-1122)
- ``verify_webdataset`` — decode-and-check shard sanity pass

Design difference vs the reference: analysis is a single streaming pass
producing an immutable ``DatasetAnalysis``; cleaning consumes that analysis
(never re-decodes); image IO is isolated so the native decoder can slot in.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import random
import shutil
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from irp_tpu_torch.data.tar import ShardWriter, iter_samples

# Animals-10 folder translations (reference data_curation.py:1147-1158).
ANIMALS10_TRANSLATE = {
    "cane": "dog",
    "cavallo": "horse",
    "elefante": "elephant",
    "farfalla": "butterfly",
    "gallina": "chicken",
    "gatto": "cat",
    "mucca": "cow",
    "pecora": "sheep",
    "ragno": "spider",
    "scoiattolo": "squirrel",
}

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


def prepare_animal_dataset(dataset_path: str,
                           destination_dir: str = "./data/raw",
                           translate: Optional[Dict[str, str]] = None,
                           verbose: bool = True) -> Dict:
    """Copy ``<dataset>/raw-img/<italian>`` to ``<dest>/<english>``.

    Also accepts an already-extracted layout where the class directories
    (italian or english names) sit directly under ``dataset_path`` with no
    ``raw-img`` level — english names pass through untranslated.
    """
    translate = dict(translate or ANIMALS10_TRANSLATE)
    # already-english dirs pass through (extracted/renamed datasets)
    for english in list(translate.values()):
        translate.setdefault(english, english)
    source_dir = os.path.join(dataset_path, "raw-img")
    if not os.path.isdir(source_dir):
        if os.path.isdir(dataset_path) and any(
                d in translate
                for d in os.listdir(dataset_path)
                if os.path.isdir(os.path.join(dataset_path, d))):
            source_dir = dataset_path  # class dirs at the top level
        else:
            if verbose:
                print(f"Source directory not found: {source_dir}")
            return {"error": "Source directory not found"}
    os.makedirs(destination_dir, exist_ok=True)

    class_stats: Dict[str, int] = {}
    failed: List[str] = []
    for folder in sorted(os.listdir(source_dir)):
        src = os.path.join(source_dir, folder)
        if not os.path.isdir(src):
            continue
        name = translate.get(folder)
        if name is None:
            failed.append(folder)
            if verbose:
                print(f"No translation for folder: {folder} (skipped)")
            continue
        dst = os.path.join(destination_dir, name)
        os.makedirs(dst, exist_ok=True)
        count = 0
        for fname in os.listdir(src):
            fsrc = os.path.join(src, fname)
            if os.path.isfile(fsrc):
                shutil.copy2(fsrc, os.path.join(dst, fname))
                count += 1
        class_stats[name] = count
        if verbose:
            print(f"  {folder} -> {name}: {count} images")
    total = sum(class_stats.values())
    if verbose:
        print(f"Copied {total} images across {len(class_stats)} classes")
    return {"total_images": total, "class_stats": class_stats,
            "untranslated": failed}


def compute_image_hash(img) -> str:
    """Duplicate-detection hash: MD5 of the 64x64 RGB pixels
    (reference data_curation.py:283-292)."""
    small = img.copy().resize((64, 64)).convert("RGB")
    return hashlib.md5(small.tobytes()).hexdigest()


@dataclass
class ImageRecord:
    path: str
    class_name: str
    width: int
    height: int
    channels: int
    hash: str

    @property
    def is_grayscale(self) -> bool:
        return self.channels == 1

    @property
    def is_rgba(self) -> bool:
        return self.channels == 4

    @property
    def min_side(self) -> int:
        return min(self.width, self.height)


@dataclass
class DatasetAnalysis:
    """Immutable result of one analysis pass (reference's 17-key report
    dict, data_curation.py:466-486, as a structured object with a
    ``to_report_dict`` view for compatibility)."""

    root: str
    class_names: List[str]
    records: List[ImageRecord]
    corrupted_files: List[Tuple[str, str]]
    duplicate_pairs: List[Tuple[str, str]]  # (dup, first-seen)
    formats: List[str]
    sample_images_by_class: Dict[str, str]

    @property
    def class_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            out[r.class_name] += 1
        return dict(out)

    @property
    def total_images(self) -> int:
        return len(self.records)

    @property
    def grayscale_images(self) -> List[str]:
        return [r.path for r in self.records if r.is_grayscale]

    @property
    def rgba_images(self) -> List[str]:
        return [r.path for r in self.records if r.is_rgba]

    def small_images(self, min_resolution: int = 128) -> List[str]:
        return [r.path for r in self.records if r.min_side < min_resolution]

    @property
    def small_image_counts(self) -> Dict[str, int]:
        return {f"below_{t}": sum(1 for r in self.records
                                  if r.width < t or r.height < t)
                for t in (224, 128, 64, 32)}

    @property
    def resolution_stats(self) -> Optional[Dict[str, float]]:
        if not self.records:
            return None
        ws = [r.width for r in self.records]
        hs = [r.height for r in self.records]
        return {"avg_width": float(np.mean(ws)),
                "avg_height": float(np.mean(hs)),
                "min_width": min(ws), "max_width": max(ws),
                "min_height": min(hs), "max_height": max(hs)}

    @property
    def aspect_ratio_stats(self) -> Optional[Dict[str, float]]:
        if not self.records:
            return None
        ratios = np.array([r.width / r.height for r in self.records])
        return {"avg_ratio": float(ratios.mean()),
                "median_ratio": float(np.median(ratios)),
                "min_ratio": float(ratios.min()),
                "max_ratio": float(ratios.max()),
                "std_ratio": float(ratios.std())}

    @property
    def aspect_ratio_categories(self) -> Optional[Dict[str, int]]:
        if not self.records:
            return None
        cats = {"square": 0, "portrait": 0, "landscape": 0}
        for r in self.records:
            ratio = r.width / r.height
            if 0.9 <= ratio <= 1.1:
                cats["square"] += 1
            elif ratio < 0.9:
                cats["portrait"] += 1
            else:
                cats["landscape"] += 1
        return cats

    @property
    def channel_distribution(self) -> Dict[int, int]:
        out: Dict[int, int] = defaultdict(int)
        for r in self.records:
            out[r.channels] += 1
        return dict(out)

    def to_report_dict(self) -> Dict:
        """The reference's report-dict shape (data_curation.py:466-486)."""
        return {
            "class_names": self.class_names,
            "class_counts": self.class_counts,
            "total_images": self.total_images,
            "unique_formats": self.formats,
            "resolutions": [(r.width, r.height) for r in self.records],
            "resolution_stats": self.resolution_stats,
            "aspect_ratio_stats": self.aspect_ratio_stats,
            "aspect_ratio_categories": self.aspect_ratio_categories,
            "aspect_ratios": [r.width / r.height for r in self.records],
            "channel_distribution": self.channel_distribution,
            "corrupted_files": self.corrupted_files,
            "grayscale_images": self.grayscale_images,
            "duplicate_images": self.duplicate_pairs,
            "rgba_images": self.rgba_images,
            "small_images": self.small_images(128),
            "small_image_counts": self.small_image_counts,
            "sample_images_by_class": self.sample_images_by_class,
            "folder_structure": {
                "root": self.root,
                "classes": [{"name": c,
                             "path": os.path.join(self.root, c),
                             "file_count": self.class_counts.get(c, 0)}
                            for c in self.class_names]},
        }


def analyze_dataset(dataset_path: str, seed: int = 0) -> DatasetAnalysis:
    """One decoding pass over ``<root>/<class>/*`` collecting stats."""
    from PIL import Image

    if not os.path.exists(dataset_path):
        raise FileNotFoundError(f"Dataset path not found: {dataset_path}")

    rng = random.Random(seed)
    class_names = sorted(d for d in os.listdir(dataset_path)
                         if os.path.isdir(os.path.join(dataset_path, d)))
    records: List[ImageRecord] = []
    corrupted: List[Tuple[str, str]] = []
    dup_pairs: List[Tuple[str, str]] = []
    formats: set = set()
    first_seen: Dict[str, str] = {}
    samples: Dict[str, str] = {}

    for cls in class_names:
        class_dir = os.path.join(dataset_path, cls)
        class_paths: List[str] = []
        for fname in sorted(os.listdir(class_dir)):
            path = os.path.join(class_dir, fname)
            if not os.path.isfile(path):
                continue
            ext = os.path.splitext(fname)[1].lower()
            if ext:
                formats.add(ext)
            try:
                with Image.open(path) as img:
                    w, h = img.size
                    # band COUNT, exactly like the reference
                    # (data_curation.py:378-383) — this deliberately
                    # classifies palette ('P') images as 1-channel
                    # "grayscale" and leaves 'LA' (2 bands) unflagged;
                    # kept as spec for cleaning-report parity.
                    channels = len(img.getbands())
                    img_hash = compute_image_hash(img)
            except Exception as e:  # noqa: BLE001 — corrupt detection
                corrupted.append((path, str(e)))
                continue
            if img_hash in first_seen:
                dup_pairs.append((path, first_seen[img_hash]))
            else:
                first_seen[img_hash] = path
            records.append(ImageRecord(path=path, class_name=cls, width=w,
                                       height=h, channels=channels,
                                       hash=img_hash))
            class_paths.append(path)
        if class_paths:
            samples[cls] = rng.choice(class_paths)

    return DatasetAnalysis(root=dataset_path, class_names=class_names,
                           records=records, corrupted_files=corrupted,
                           duplicate_pairs=dup_pairs,
                           formats=sorted(formats),
                           sample_images_by_class=samples)


def display_dataset_report(analysis: DatasetAnalysis,
                           report_path: Optional[str] = None,
                           sample_grid_path: Optional[str] = None) -> dict:
    """Render the analysis: pandas tables of the classes and the quality
    flags (returned), the report printed as :func:`render_analysis_report`
    writes it (and as Markdown in a notebook), the report file at
    ``report_path`` and a grid of one sample image per class at
    ``sample_grid_path`` when given (reference data_curation.py:89-281)."""
    import pandas as pd

    counts = analysis.class_counts
    class_table = pd.DataFrame({
        "class": list(analysis.class_names),
        "images": [counts.get(c, 0) for c in analysis.class_names],
    })
    class_table["share_%"] = (100.0 * class_table["images"]
                              / max(analysis.total_images, 1)).round(2)
    quality = pd.DataFrame({
        "flag": ["grayscale", "rgba", "duplicates", "corrupted",
                 "below_224", "below_128", "below_64", "below_32"],
        "count": [len(analysis.grayscale_images),
                  len(analysis.rgba_images),
                  len(analysis.duplicate_pairs),
                  len(analysis.corrupted_files),
                  analysis.small_image_counts["below_224"],
                  analysis.small_image_counts["below_128"],
                  analysis.small_image_counts["below_64"],
                  analysis.small_image_counts["below_32"]],
    })
    grid_name = os.path.basename(sample_grid_path) if sample_grid_path \
        else "sample_images.png"
    # in a notebook, the rich Markdown form ...
    try:
        from IPython import get_ipython
        from IPython.display import Markdown, display
        if get_ipython() is not None:
            display(Markdown(render_analysis_markdown(analysis, grid_name)))
    except ImportError:
        pass
    # ... while stdout always mirrors the report file
    print(render_analysis_report(analysis, grid_name), end="")

    out = {"class_table": class_table, "quality_table": quality}
    if report_path:
        out["report_path"] = write_analysis_report(analysis, report_path,
                                                   grid_name)
    if sample_grid_path and analysis.sample_images_by_class:
        from PIL import Image

        from irp_tpu_torch.utils.viz import plot_image_grid

        images, titles = [], []
        for cls, path in sorted(analysis.sample_images_by_class.items()):
            try:
                with Image.open(path) as img:
                    images.append(np.asarray(img.convert("RGB")))
                titles.append(cls)
            except OSError:
                continue
        out["sample_grid_path"] = plot_image_grid(
            images, titles, sample_grid_path,
            suptitle="Sample images by class")
    return out


def _summary_frame(analysis: DatasetAnalysis):
    import pandas as pd

    return pd.DataFrame({
        "Total Classes": [len(analysis.class_names)],
        "Total Images": [analysis.total_images],
        "Avg Images/Class": [analysis.total_images
                             / max(1, len(analysis.class_names))],
        "Unique Formats": [len(analysis.formats)],
        "Corrupted Files": [len(analysis.corrupted_files)],
    })


def _small_image_frame(analysis: DatasetAnalysis):
    import pandas as pd

    return pd.DataFrame(
        [{"Threshold": k.replace("below_", "< ") + "px", "Count": v,
          "% of Total":
          f"{v / max(1, analysis.total_images) * 100:.1f}%"}
         for k, v in analysis.small_image_counts.items()])


def _class_distribution_frame(analysis: DatasetAnalysis):
    import pandas as pd

    df = pd.DataFrame(list(analysis.class_counts.items()),
                      columns=["Class", "Count"])
    if not df.empty:
        df["% Total"] = (df["Count"] / max(1, analysis.total_images)
                         * 100).round(1)
        df = df.sort_values("Count", ascending=False)
    return df


def _resolution_frame(analysis: DatasetAnalysis):
    import pandas as pd

    rs = analysis.resolution_stats
    if not rs:
        return None
    return pd.DataFrame({
        "Metric": ["Average", "Minimum", "Maximum"],
        "Width": [round(rs["avg_width"], 1), rs["min_width"],
                  rs["max_width"]],
        "Height": [round(rs["avg_height"], 1), rs["min_height"],
                   rs["max_height"]],
    })


def render_analysis_report(analysis: DatasetAnalysis,
                           sample_grid_name: str = "sample_images.png") -> str:
    """Render the analysis in the committed golden layout.

    Byte-format parity with the reference's dataset_analysis_report.txt
    (the stdout mirror of the reference's report display,
    data_curation.py:89-281): section headers with markdown/emoji stripped,
    pandas ``to_string`` tables, identical section order and labels.
    """
    import io as _io

    import pandas as pd

    buf = _io.StringIO()

    def w(s=""):
        print(s, file=buf)

    # Dataset Folder Structure (reference :119-134)
    w("Dataset Folder Structure")
    counts = analysis.class_counts
    structure = f"DATASET_PATH: {analysis.root}\nFOLDER_STRUCTURE:\n"
    for cls in analysis.class_names:
        structure += f"  - {cls} ({counts.get(cls, 0)} images)\n"
    w("\nDATASET STRUCTURE FOR CHATBOT REFERENCE:")
    w(structure)

    # Summary Statistics (reference :136-148)
    w("Dataset Summary Statistics")
    w("\nKEY STATISTICS:")
    w(_summary_frame(analysis).to_string(index=False))

    # Small Images (reference :150-163)
    w("Small Image Analysis")
    w("\nSMALL IMAGE DISTRIBUTION:")
    w(_small_image_frame(analysis).to_string(index=False))

    # Class Distribution (reference :165-175)
    w("Class Distribution")
    class_df = _class_distribution_frame(analysis)
    if not class_df.empty:
        w("\nCLASS DISTRIBUTION (SORTED BY COUNT):")
        w(class_df.to_string(index=False))

    # Image Characteristics (reference :177-237)
    w("Image Characteristics")
    res_df = _resolution_frame(analysis)
    if res_df is not None:
        w("\nRESOLUTION STATISTICS (PIXELS):")
        w(res_df.set_index("Metric").to_string())

    ars = analysis.aspect_ratio_stats
    if ars:
        ar_df = pd.DataFrame({
            "Metric": ["Average", "Median", "Minimum", "Maximum",
                       "Std Dev"],
            "Value": [round(ars["avg_ratio"], 2),
                      round(ars["median_ratio"], 2),
                      round(ars["min_ratio"], 2),
                      round(ars["max_ratio"], 2),
                      round(ars["std_ratio"], 2)],
        }).set_index("Metric")
        w("\nASPECT RATIO STATISTICS (WIDTH/HEIGHT):")
        w(ar_df.to_string())

        arc = analysis.aspect_ratio_categories
        if arc:
            total = max(sum(arc.values()), 1)
            arc_df = pd.DataFrame({
                "Category": ["Square (0.9-1.1)", "Portrait (<0.9)",
                             "Landscape (>1.1)"],
                "Count": [arc["square"], arc["portrait"], arc["landscape"]],
                "% of Total": [f"{arc['square'] / total * 100:.1f}%",
                               f"{arc['portrait'] / total * 100:.1f}%",
                               f"{arc['landscape'] / total * 100:.1f}%"],
            })
            w("\nASPECT RATIO CATEGORIES:")
            w(arc_df.to_string(index=False))

    channel_df = pd.DataFrame(list(analysis.channel_distribution.items()),
                              columns=["Channels", "Count"])
    if not channel_df.empty:
        channel_df["Channel Type"] = channel_df["Channels"].map(
            {1: "Grayscale", 3: "RGB", 4: "RGBA"})
        w("\nCOLOR CHANNELS:")
        w(channel_df[["Channel Type", "Count"]].to_string(index=False))

    # File Formats (reference :239-244)
    w("File Formats")
    format_df = pd.DataFrame(analysis.formats, columns=["Extensions"])
    w("\nFOUND FILE EXTENSIONS:")
    w(format_df.to_string(index=False))

    # Corrupted Files (reference :246-257)
    w("Corrupted Files")
    if analysis.corrupted_files:
        corrupt_df = pd.DataFrame(analysis.corrupted_files,
                                  columns=["Path", "Error"])
        w(f"\nTOTAL CORRUPTED: {len(corrupt_df)}")
        w("SAMPLE CORRUPTED FILES:")
        w(corrupt_df.head(5).to_string(index=False))
    else:
        w("\nOK: No corrupted files found")

    # Sample Images (reference :259-262)
    w("Sample Images")
    w(f"\nSample images saved to '{sample_grid_name}'")
    return buf.getvalue()


def render_analysis_markdown(analysis: DatasetAnalysis,
                             sample_grid_name: str =
                             "sample_images.png") -> str:
    """The analysis as Markdown with the reference's emoji section headers
    (reference data_curation.py:120-260 displays these through IPython;
    :func:`render_analysis_report` is the emoji-stripped text mirror), for
    ``IPython.display.Markdown`` or any Markdown viewer."""
    parts = []
    counts = analysis.class_counts

    parts.append("## 📂 Dataset Folder Structure")
    structure = f"DATASET_PATH: {analysis.root}\nFOLDER_STRUCTURE:\n"
    for cls in analysis.class_names:
        structure += f"  - {cls} ({counts.get(cls, 0)} images)\n"
    parts.append(f"```\n{structure}```")

    parts.append("## 📊 Dataset Summary Statistics")
    summary = _summary_frame(analysis)
    summary["Avg Images/Class"] = summary["Avg Images/Class"].round(1)
    parts.append(summary.to_markdown(index=False))

    parts.append("## 🔍 Small Image Analysis")
    parts.append(_small_image_frame(analysis).to_markdown(index=False))

    parts.append("## 📁 Class Distribution")
    class_df = _class_distribution_frame(analysis)
    if not class_df.empty:
        parts.append(class_df.to_markdown(index=False))

    parts.append("## 🖼️ Image Characteristics")
    res_df = _resolution_frame(analysis)
    if res_df is not None:
        parts.append(res_df.to_markdown(index=False))

    parts.append("## 📄 File Formats")
    parts.append(", ".join(f"`{f}`" for f in analysis.formats) or "none")

    parts.append("## ❌ Corrupted Files")
    if analysis.corrupted_files:
        parts.append(f"⚠️ {len(analysis.corrupted_files)} corrupted "
                     "files found")
    else:
        parts.append("✅ No corrupted files found")

    parts.append("## 📸 Sample Images")
    parts.append(f"Sample images saved to `{sample_grid_name}`")
    return "\n\n".join(parts) + "\n"


def write_analysis_report(analysis: DatasetAnalysis, path: str,
                          sample_grid_name: str = "sample_images.png") -> str:
    """Golden-format dataset_analysis_report.txt (see
    render_analysis_report)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_analysis_report(analysis, sample_grid_name))
    return path


@dataclass
class CleaningStats:
    total_processed: int = 0
    total_copied: int = 0
    excluded: Dict[str, int] = field(default_factory=lambda: {
        "grayscale": 0, "rgba": 0, "small": 0, "duplicate": 0})
    class_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def total_excluded(self) -> int:
        return sum(self.excluded.values())


def clean_image_dataset(src_path: str, dest_path: str,
                        keep_grayscale: bool = False,
                        keep_rgba: bool = False,
                        keep_duplicates: bool = False,
                        min_resolution: Optional[int] = 128,
                        analysis: Optional[DatasetAnalysis] = None,
                        report_path: Optional[str] = None,
                        verbose: bool = True) -> CleaningStats:
    """Copy-filter the dataset per the exclusion rules
    (reference data_curation.py:488-635)."""
    analysis = analysis or analyze_dataset(src_path)
    os.makedirs(dest_path, exist_ok=True)

    # Priority order for attribution when multiple rules match a file:
    # grayscale > rgba > small > duplicate (matches reference accounting).
    # Note a duplicate is excluded even when its first-seen "original" is
    # itself excluded by another rule — per-image independent rules, same
    # as the reference cleaner (data_curation.py:488-635); a content-aware
    # "keep the best copy" policy would diverge from the committed
    # cleaning-report numbers.
    reasons: Dict[str, str] = {}
    if not keep_duplicates:
        for dup, _ in analysis.duplicate_pairs:
            reasons[dup] = "duplicate"
    if min_resolution is not None:
        for p in analysis.small_images(min_resolution):
            reasons[p] = "small"
    if not keep_rgba:
        for p in analysis.rgba_images:
            reasons[p] = "rgba"
    if not keep_grayscale:
        for p in analysis.grayscale_images:
            reasons[p] = "grayscale"

    stats = CleaningStats()
    for cls in analysis.class_names:
        dest_class = os.path.join(dest_path, cls)
        os.makedirs(dest_class, exist_ok=True)
    for record in analysis.records:
        stats.total_processed += 1
        reason = reasons.get(record.path)
        if reason is not None:
            stats.excluded[reason] += 1
            continue
        dst = os.path.join(dest_path, record.class_name,
                           os.path.basename(record.path))
        try:
            shutil.copy2(record.path, dst)
        except OSError as e:
            if verbose:
                print(f"Copy failed for {record.path}: {e}")
            continue
        stats.total_copied += 1
        stats.class_counts[record.class_name] = stats.class_counts.get(
            record.class_name, 0) + 1

    if report_path:
        write_cleaning_report(stats, src_path, dest_path, report_path)
    if verbose:
        print(f"Cleaned dataset: {stats.total_copied}/"
              f"{stats.total_processed} copied "
              f"({stats.total_excluded} excluded)")
    return stats


def write_cleaning_report(stats: CleaningStats, src: str, dest: str,
                          path: str) -> str:
    """dataset_cleaning_report.txt format (golden artifact in the
    reference repo)."""
    lines = ["DATASET CLEANING REPORT", "=" * 22, "",
             f"Source Dataset: {src}", f"Cleaned Dataset: {dest}", "",
             "SUMMARY STATISTICS", "-" * 18,
             f"Total files processed: {stats.total_processed}",
             f"Total files copied: {stats.total_copied}",
             f"Total files excluded: {stats.total_excluded}", "",
             "EXCLUSION DETAILS", "-" * 16,
             f"Grayscale images excluded: {stats.excluded['grayscale']}",
             f"RGBA images excluded: {stats.excluded['rgba']}",
             f"Small images excluded: {stats.excluded['small']}",
             f"Duplicate images excluded: {stats.excluded['duplicate']}",
             "", "CLASS DISTRIBUTION IN CLEANED DATASET", "-" * 36]
    for cls in sorted(stats.class_counts):
        lines.append(f"{cls}: {stats.class_counts[cls]} images")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def resize_and_crop_image(img, target_size: int = 224):
    """RGBA->RGB white composite, short-side LANCZOS resize, center crop
    (reference data_curation.py:886-915)."""
    from PIL import Image

    if img.mode == "RGBA":
        background = Image.new("RGB", img.size, (255, 255, 255))
        background.paste(img, mask=img.split()[3])
        img = background
    elif img.mode != "RGB":
        img = img.convert("RGB")

    w, h = img.size
    if w < h:
        new_w, new_h = target_size, int(h * (target_size / w))
    else:
        new_w, new_h = int(w * (target_size / h)), target_size
    img = img.resize((new_w, new_h), Image.Resampling.LANCZOS)
    left = (new_w - target_size) // 2
    top = (new_h - target_size) // 2
    return img.crop((left, top, left + target_size, top + target_size))


def get_dataset_info(input_dir: str):
    """{class: [image paths]} for .jpg/.jpeg/.png files."""
    out: Dict[str, List[str]] = {}
    for cls in sorted(os.listdir(input_dir)):
        class_dir = os.path.join(input_dir, cls)
        if not os.path.isdir(class_dir):
            continue
        paths: List[str] = []
        for ext in IMAGE_EXTENSIONS:
            paths.extend(glob.glob(os.path.join(class_dir, f"*{ext}")))
            paths.extend(glob.glob(os.path.join(class_dir,
                                                f"*{ext.upper()}")))
        out[cls] = sorted(set(paths))
    return out


def create_balanced_test_set(dataset_info: Dict[str, List[str]],
                             test_size: float = 0.2, seed: int = 42):
    """Balanced test split: ``min_class_count * test_size`` samples PER
    CLASS to test, everything else to train; both shuffled
    (reference data_curation.py:917-966)."""
    rng = random.Random(seed)
    counts = {c: len(paths) for c, paths in dataset_info.items() if paths}
    if not counts:
        return [], []
    min_count = min(counts.values())
    per_class_test = int(min_count * test_size)

    train_files: List[Tuple[str, str]] = []
    test_files: List[Tuple[str, str]] = []
    for cls, paths in dataset_info.items():
        paths = list(paths)
        rng.shuffle(paths)
        test_files.extend((p, cls) for p in paths[:per_class_test])
        train_files.extend((p, cls) for p in paths[per_class_test:])
    rng.shuffle(train_files)
    rng.shuffle(test_files)
    return train_files, test_files


def write_webdataset(data_files: Sequence[Tuple[str, str]],
                     output_path: str, prefix: str,
                     samples_per_shard: int = 1000,
                     target_size: int = 224,
                     verbose: bool = True) -> List[str]:
    """Standardize + write samples into ``<prefix>-%06d.tar`` shards with
    the reference schema {__key__, jpg, cls, json}
    (reference data_curation.py:968-1025, sample dict :1006-1012)."""
    from PIL import Image

    writer = ShardWriter(output_path, prefix, samples_per_shard)
    with writer:
        for i, (path, cls) in enumerate(data_files):
            try:
                with Image.open(path) as img:
                    std = resize_and_crop_image(img, target_size)
                buf = io.BytesIO()
                std.save(buf, format="JPEG")
            except Exception as e:  # noqa: BLE001 — skip unreadable files
                if verbose:
                    print(f"Error processing {path}: {e}")
                continue
            key = f"{cls}_{i:06d}"
            writer.write({"__key__": key, "jpg": buf.getvalue(),
                          "cls": cls, "json": {"class": cls, "id": key}})
    if verbose:
        print(f"Wrote {writer.total} samples to "
              f"{len(writer.shard_paths)} {prefix} shards")
    return writer.shard_paths


def process_dataset(input_dir: str, output_dir: str, test_size: float = 0.2,
                    samples_per_shard: int = 1000, target_size: int = 224,
                    seed: int = 42, verbose: bool = True) -> Dict:
    """Split + standardize + shard write (reference
    data_curation.py:1027-1063)."""
    os.makedirs(output_dir, exist_ok=True)
    info = get_dataset_info(input_dir)
    train_files, test_files = create_balanced_test_set(info, test_size,
                                                       seed)
    if verbose:
        print(f"Split: {len(train_files)} train / {len(test_files)} test")
    train_shards = write_webdataset(train_files, output_dir, "train",
                                    samples_per_shard, target_size, verbose)
    test_shards = write_webdataset(test_files, output_dir, "test",
                                   samples_per_shard, target_size, verbose)
    return {"train_shards": train_shards, "test_shards": test_shards,
            "n_train": len(train_files), "n_test": len(test_files)}


def verify_webdataset(pattern_or_paths, num_samples: int = 5,
                      target_size: int = 224, verbose: bool = True) -> Dict:
    """Decode N samples per shard set and sanity-check the schema
    (reference data_curation.py:1065-1122)."""
    from PIL import Image

    paths = (sorted(glob.glob(pattern_or_paths))
             if isinstance(pattern_or_paths, str) else list(pattern_or_paths))
    checked = 0
    classes: Counter = Counter()
    problems: List[str] = []
    for sample in iter_samples(paths):
        if checked >= num_samples:
            break
        key = sample.get("__key__", "?")
        try:
            img = Image.open(io.BytesIO(sample["jpg"]))
            img.load()
            if img.size != (target_size, target_size):
                problems.append(f"{key}: size {img.size}")
            cls = sample["cls"].decode("utf-8")
            meta = json.loads(sample["json"])
            if meta.get("class") != cls:
                problems.append(f"{key}: json/cls mismatch")
            classes[cls] += 1
        except Exception as e:  # noqa: BLE001
            problems.append(f"{key}: {e}")
        checked += 1
    if checked == 0:
        # an empty match (typo'd glob, missing dir) must not pass
        problems.append(f"no samples found for {pattern_or_paths!r}")
    ok = not problems
    if verbose:
        print(f"Verified {checked} samples: "
              f"{'OK' if ok else f'{len(problems)} problems'}")
        for p in problems:
            print(f"  {p}")
    return {"checked": checked, "ok": ok, "problems": problems,
            "classes": dict(classes)}
