"""IndexWriter lifecycle tests: flush, commit, reopen, deletes, merges,
rollback — mirroring the reference's index-layer test suite
(ConcurrentMergeTest, IndexWriterRollbackTest, ReaderReopenTest,
MergeCommitPointTest; SURVEY.md section 4)."""

import numpy as np
import pytest

from diagon_tpu.document import Document, StoredField, TextField
from diagon_tpu.index.reader import DirectoryReader
from diagon_tpu.index.writer import (
    IndexWriter,
    IndexWriterConfig,
    find_latest_commit_gen,
)
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import TermQuery
from diagon_tpu.store import FSDirectory, LockObtainFailedError


def _doc(text, doc_id=None):
    d = Document().add(TextField("body", text))
    if doc_id is not None:
        d.add(StoredField("id", doc_id))
    return d


def _search(reader, term, k=10):
    return OracleSearcher(reader.segments_data()).search(
        TermQuery("body", term), k
    )


def test_add_commit_reopen(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil price", "a"))
        w.add_document(_doc("trade news", "b"))
        gen = w.commit()
        assert gen >= 1

    r = DirectoryReader.open(d)
    assert r.max_doc() == 2
    assert _search(r, "oil").doc_ids() == [0]
    assert r.document(0) == {"id": "a"}
    assert r.document(1) == {"id": "b"}


def test_single_writer_lock(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d)
    with pytest.raises(LockObtainFailedError):
        IndexWriter(d)
    w.close()
    IndexWriter(d).close()


def test_multi_flush_segments_and_force_merge(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=2, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(7):
            w.add_document(_doc(f"doc number w{i} oil", str(i)))
        w.flush()
        assert w.segment_count >= 3
        w.force_merge(1)
        assert w.segment_count == 1
        w.commit()

    r = DirectoryReader.open(d)
    assert r.max_doc() == 7
    assert len(r.leaves()) == 1
    td = _search(r, "oil")
    assert td.total_hits == 7
    # stored fields survive merge in docid order
    assert [r.document(i)["id"] for i in range(7)] == [str(i) for i in range(7)]


def test_merge_preserves_scores(tmp_path):
    """Multi-segment scores == single merged segment scores (same stats)."""
    d1 = FSDirectory(tmp_path / "multi")
    texts = [f"oil price w{i} {'extra words ' * (i % 3)}" for i in range(20)]
    cfg = IndexWriterConfig(max_buffered_docs=4, merge_scheduler="serial")
    with IndexWriter(d1, cfg) as w:
        for t in texts:
            w.add_document(_doc(t))
        w.commit()
    r1 = DirectoryReader.open(d1)
    before = _search(r1, "oil")

    d2 = FSDirectory(tmp_path / "merged")
    with IndexWriter(d2, cfg) as w:
        for t in texts:
            w.add_document(_doc(t))
        w.force_merge(1)
        w.commit()
    r2 = DirectoryReader.open(d2)
    after = _search(r2, "oil")

    assert before.doc_ids() == after.doc_ids()
    assert [s.score for s in before.score_docs] == [
        s.score for s in after.score_docs
    ]


def test_delete_documents(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil alpha"))
        w.add_document(_doc("oil beta"))
        w.add_document(_doc("gas gamma"))
        w.commit()
        n = w.delete_documents("body", "alpha")
        assert n == 1
        assert w.num_docs() == 2
        w.commit()

    r = DirectoryReader.open(d)
    assert r.num_docs() == 2
    td = _search(r, "oil")
    assert td.total_hits == 1


def test_delete_buffered_docs(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil alpha"))
        w.add_document(_doc("oil beta"))
        # no flush yet: delete must hit RAM-buffered docs too
        assert w.delete_documents("body", "alpha") == 1
        w.commit()
    r = DirectoryReader.open(d)
    assert r.num_docs() == 1


def test_update_document(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil version1 keyx"))
        w.commit()
        w.update_document("body", "keyx", _doc("oil version2 keyx"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.num_docs() == 1
    seg_data = r.segments_data()
    s = OracleSearcher(seg_data)
    assert s.search(TermQuery("body", "version2"), 10).total_hits == 1
    assert s.search(TermQuery("body", "version1"), 10).total_hits == 0


def test_merge_with_deletes_compacts(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=3, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(9):
            w.add_document(_doc(f"doc t{i} common", str(i)))
        w.flush()
        w.delete_documents("body", "t4")
        w.delete_documents("body", "t7")
        w.force_merge(1)
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 7  # deletions compacted away
    assert r.num_docs() == 7
    ids = [r.document(i)["id"] for i in range(7)]
    assert ids == ["0", "1", "2", "3", "5", "6", "8"]


def test_rollback(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d, IndexWriterConfig(merge_scheduler="serial"))
    w.add_document(_doc("committed doc oil"))
    w.commit()
    w.add_document(_doc("uncommitted doc gas"))
    w.flush()
    w.rollback()
    assert w.num_docs() == 1
    w.close()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 1
    # uncommitted segment files cleaned up
    stray = [f for f in d.list_files() if f.endswith(".bnd")]
    assert len(stray) == 1


def test_concurrent_merge_scheduler(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(
        max_buffered_docs=2,
        merge_scheduler="concurrent",
        merge_policy=__import__(
            "diagon_tpu.index.merge", fromlist=["TieredMergePolicy"]
        ).TieredMergePolicy(segs_per_tier=2, max_merge_at_once=4),
    )
    with IndexWriter(d, cfg) as w:
        for i in range(20):
            w.add_document(_doc(f"background doc w{i} oil"))
        w.commit()
        w.wait_for_merges()
        w.commit_merge_results()
        assert w.segment_count < 10
    r = DirectoryReader.open(d)
    assert r.max_doc() == 20
    assert _search(r, "oil").total_hits == 20


def test_append_mode(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("first oil"))
        w.commit()
    with IndexWriter(
        d, IndexWriterConfig(open_mode="APPEND", merge_scheduler="serial")
    ) as w:
        w.add_document(_doc("second oil"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 2
    assert _search(r, "oil").total_hits == 2


def test_create_mode_truncates(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("old oil"))
        w.commit()
    with IndexWriter(
        d, IndexWriterConfig(open_mode="CREATE", merge_scheduler="serial")
    ) as w:
        w.add_document(_doc("new gas"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 1
    assert _search(r, "gas").total_hits == 1


def test_reader_reopen(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d, IndexWriterConfig(merge_scheduler="serial"))
    w.add_document(_doc("one oil"))
    w.commit()
    r1 = DirectoryReader.open(d)
    w.add_document(_doc("two oil"))
    w.commit()
    assert r1.max_doc() == 1  # point-in-time snapshot
    r2 = r1.reopen()
    assert r2.max_doc() == 2
    w.close()


def test_generation_cleanup(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        for i in range(3):
            w.add_document(_doc(f"gen doc {i}"))
            w.commit()
    gens = [f for f in d.list_files() if f.startswith("segments_")]
    assert len(gens) == 1  # stale generations removed
    assert find_latest_commit_gen(d) is not None


def test_merge_preserves_doc_values_and_points(tmp_path):
    from diagon_tpu.document import (
        LongPointField,
        NumericDocValuesField,
        SortedDocValuesField,
    )
    from diagon_tpu.search.query import NumericRangeQuery, PointRangeQuery

    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=3, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(9):
            w.add_document(
                Document()
                .add(TextField("body", f"doc t{i} common"))
                .add(NumericDocValuesField("views", i * 10))
                .add(LongPointField("ts", i * 100))
                .add(SortedDocValuesField("cat", chr(ord("a") + i % 3)))
            )
        w.delete_documents("body", "t4")
        w.force_merge(1)
        w.commit()

    r = DirectoryReader.open(d)
    assert r.max_doc() == 8
    s = OracleSearcher(r.segments_data())
    # views of surviving docs remapped in docid order: t4 (views 40) gone
    td = s.search(NumericRangeQuery("views", 30, 60), 10)
    views = sorted(
        r.segments_data()[0].doc_values["views"].values[i] for i in td.doc_ids()
    )
    assert views == [30, 50, 60]
    td2 = s.search(PointRangeQuery("ts", 700, None), 10)
    assert len(td2.doc_ids()) == 2  # t7, t8
    # sorted doc values ord table intact
    dv = r.segments_data()[0].doc_values["cat"]
    assert dv.ord_values == [b"a", b"b", b"c"]


def test_searcher_accepts_leaf_contexts(tmp_path):
    from diagon_tpu.document import Document, TextField
    from diagon_tpu.index import DirectoryReader, IndexWriter
    from diagon_tpu.search import IndexSearcher, TermQuery
    from diagon_tpu.store import FSDirectory

    w = IndexWriter(FSDirectory(str(tmp_path)))
    w.add_document(Document().add(TextField("b", "alpha beta")))
    w.commit()
    w.close()
    r = DirectoryReader.open(FSDirectory(str(tmp_path)))
    s = IndexSearcher(r.leaves())  # LeafReaderContext list, like the ref API
    assert s.search(TermQuery("b", "alpha"), k=5).total_hits == 1


def test_add_segment_commit_reopen(tmp_path):
    """A segment built outside the writer (the bulk builder) commits
    under the writer's next name beside flushed segments, and reopens
    with identical search results."""
    from diagon_tpu.bench.bulk_build import build_synthetic_segment

    seg = build_synthetic_segment(num_docs=600)
    want = OracleSearcher([seg]).search(TermQuery("body", "oil"), 10)
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil price"))
        w.flush()
        w.add_segment(seg)
        w.commit()
    r = DirectoryReader.open(d)
    assert [s.num_docs for s in r.segments_data()] == [1, 600]
    assert len({s.name for s in r.segments_data()}) == 2
    got = OracleSearcher([r.segments_data()[1]]).search(
        TermQuery("body", "oil"), 10
    )
    assert got.doc_ids() == want.doc_ids()
    assert [x.score for x in got.score_docs] == [
        x.score for x in want.score_docs
    ]
