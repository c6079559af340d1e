"""Fleet data generators: subclass and override generate_sample(line)
to turn raw input lines into MultiSlot records; run_from_stdin /
run_from_files / run_from_memory emit the text format that
distributed/dataset.py's MultiSlotDataFeed parses (`<len> v1 v2 ...
<len> v1 ...`), which InMemoryDataset and QueueDataset load.
Counterpart of paddle_tpu/distributed/fleet/data_generator.py (the
reference's incubate data_generator); host code, ported as it is."""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 32
        self._proto_info = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- user overrides ------------------------------------------------------
    def generate_sample(self, line):
        """Return a zero-arg iterator yielding one or more samples for
        this input line; each sample is [(slot_name, [values...]), ...]."""
        raise NotImplementedError(
            "subclasses must implement generate_sample(line)")

    def generate_batch(self, samples):
        """Optional batch-level hook: receives batch_size_ samples,
        returns a zero-arg iterator of (possibly transformed) samples."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- drivers -------------------------------------------------------------
    def _emit(self, sample, out):
        out.write(self._gen_str(sample))

    def _drive(self, lines, out):
        batch = []
        for line in lines:
            it = self.generate_sample(line)
            if it is None:
                continue
            for sample in it():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    for s in self.generate_batch(batch)():
                        self._emit(s, out)
                    batch = []
        if batch:
            for s in self.generate_batch(batch)():
                self._emit(s, out)

    def run_from_stdin(self):
        self._drive(sys.stdin, sys.stdout)

    def run_from_memory(self, lines=None, out=None):
        """Drive from an in-memory line list; returns the emitted text
        when no output stream is given."""
        import io
        buf = out or io.StringIO()
        self._drive(lines or [], buf)
        if out is None:
            return buf.getvalue()

    def run_from_files(self, filelist, out=None):
        def all_lines():
            # ONE stream across the filelist so generate_batch sees full
            # batch_size_ batches spanning file boundaries (reference
            # DataGenerator accumulates across files)
            for fn in filelist:
                with open(fn) as f:
                    yield from f

        self._drive(all_lines(), out or sys.stdout)

    def _gen_str(self, line):
        raise NotImplementedError(
            "pick MultiSlotDataGenerator or MultiSlotStringDataGenerator")


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: emits `<len> v1 v2 ...` per slot, tracking each
    slot's type (uint64 until a float appears)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample() must be list/tuple of "
                "(name, [values]) pairs")
        parts = []
        first_pass = self._proto_info is None
        if first_pass:
            self._proto_info = []
        elif len(line) != len(self._proto_info):
            # the MultiSlot text format is positional — a short record
            # would silently misalign every later value in the feed
            raise ValueError(
                f"sample has {len(line)} slots, expected "
                f"{len(self._proto_info)} "
                f"({[n for n, _ in self._proto_info]})")
        for i, (name, elements) in enumerate(line):
            if not isinstance(name, str):
                raise ValueError(f"slot name {name!r} must be str")
            if not isinstance(elements, list) or not elements:
                raise ValueError(
                    f"slot {name!r} needs a non-empty value list (pad "
                    f"in generate_sample if necessary)")
            if first_pass:
                self._proto_info.append((name, "uint64"))
            elif i >= len(self._proto_info) or \
                    self._proto_info[i][0] != name:
                raise ValueError(
                    f"slot order changed: expected "
                    f"{self._proto_info[i][0] if i < len(self._proto_info) else '<none>'!r},"
                    f" got {name!r}")
            parts.append(str(len(elements)))
            for elem in elements:
                if isinstance(elem, float):
                    self._proto_info[i] = (name, "float")
                elif not isinstance(elem, int):
                    raise ValueError(
                        f"slot {name!r} values must be int or float, "
                        f"got {type(elem).__name__}")
                parts.append(str(elem))
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """String slots: emits `<len> s1 s2 ...` per slot without type
    tracking (values pass through verbatim)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample() must be list/tuple of "
                "(name, [values]) pairs")
        parts = []
        for name, elements in line:
            if not isinstance(elements, (list, tuple)) or not elements:
                raise ValueError(
                    f"slot {name!r} needs a non-empty value list")
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"
