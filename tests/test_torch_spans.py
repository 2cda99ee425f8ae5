"""The port's spans and counters (``utils/profiling.py``): off without a
profiler, inert on the program's results when on, and, under
``profiling.trace``, the DQN iteration's and the zoo agent move's spans
and counters as the code runs them.  The stream times and the fold of a
root's CUDA events run here on stand-in events (no card on the CPU)."""

import json

import numpy as np
import pytest
import torch

from gobblet_rl_torch import zoo
from gobblet_rl_torch.core import observe, rules_np
from gobblet_rl_torch.ops import batched_core as bc
from gobblet_rl_torch.train import dqn
from gobblet_rl_torch.train import replay
from gobblet_rl_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 2**33 + 7
PHASES = ("dqn.collect", "dqn.insert", "dqn.sample", "dqn.updates")
MOVE = ["zoo.move", "zoo.decode", "zoo.upload", "zoo.policy", "zoo.readback"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a few cores, where torch's thread pools would oversubscribe
    them and small ops slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_table():
    profiling.TABLE.reset()
    yield
    profiling.TABLE.reset()


def tiny_config(**kw):
    fields = dict(num_envs=16, segment_len=4, n_step=3, update_per_collect=2, batch_size=32,
                  buffer_size=1024, hidden_sizes=(16, 16), learner_player="both",
                  opponent="random")
    fields.update(kw)
    return dqn.DQNConfig(**fields)


def setup(config, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    ts = dqn.init_train_state(config, dqn.make_net(config, CPU), gen)
    iteration, opponent_fn = dqn.make_train_iteration(config)
    env = dqn.init_env_state(config, opponent_fn, ts.opponent_net, gen)
    return gen, ts, iteration, opponent_fn, env, replay.make_buffer(config.buffer_size, CPU)


def one_iteration(config, seed=SEED):
    gen, ts, iteration, _, env, buf = setup(config, seed)
    env, buf, loss = iteration(ts, env, buf, gen)
    return gen, ts, env, buf, loss


def positions(n, seed=3):
    """(observation, mask) of the first plies of a numpy-seeded random game."""
    rng = np.random.default_rng(seed)
    board, player, out = rules_np.empty_board(), 0, []
    while len(out) < n:
        obs, mask = observe.observe_np(board, player, player)
        out.append((obs, mask))
        board = rules_np.apply_action(board, player, int(rng.choice(np.nonzero(mask)[0])))
        player = 1 - player
    return out


def test_off_records_nothing():
    """Without a profiler a span is one shared object that does nothing and
    a count is dropped: an iteration and a move leave the table empty."""
    assert not profiling.enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a"):
        profiling.count("c", 3)
    one_iteration(tiny_config())
    obs, mask = positions(1)[0]
    zoo.host_agent("dqn_greedy", device="cpu").compute_action(obs, mask)
    assert profiling.span_table() == {"roots": 0, "spans": {}, "counters": {}}


@pytest.mark.parametrize("learner_player", [0, 1, "both"])
def test_profiler_leaves_the_iteration_unchanged(learner_player):
    """The spans and counters draw nothing from the generator and change no
    result: env state, ring, loss, parameters and the generator's state are
    identical with the profiler on and off."""
    config = tiny_config(learner_player=learner_player)
    off = one_iteration(config)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = one_iteration(config)
    assert profiling.span_table()["roots"] > 0
    (gen0, ts0, env0, buf0, loss0), (gen1, ts1, env1, buf1, loss1) = off, on
    assert torch.equal(gen0.get_state(), gen1.get_state())
    for a, b in zip(env0, env1):
        assert torch.equal(a, b)
    for a, b in zip(buf0, buf1):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert torch.equal(loss0, loss1)
    for (k, a), b in zip(ts0.net.state_dict().items(), ts1.net.state_dict().values()):
        assert torch.equal(a, b), k


def replayed_counts(config):
    """The collect of :func:`one_iteration` replayed step by step from the
    same seed: the env state it ends in, the rows the opponent ran on and
    the rows whose board its move changed (where the third step's select
    kept it)."""
    gen, ts, _, opponent_fn, env, _ = setup(config)
    B, L = config.num_envs, config.segment_len + config.n_step - 1
    seat = dqn.seat_array(config.learner_player, B, CPU)
    rows = played = 0
    with torch.no_grad():
        for _ in range(L):
            mask = bc.legal_mask_planes(env.board, env.current).t()
            q = ts.net(dqn._obs_bf(env.board, env.current))
            s1 = bc.step_trusted(env, dqn._eps_greedy(gen, q, mask, env.board, env.current,
                                                      config.eps_train))
            s2 = bc.step_trusted(s1, opponent_fn(gen, s1.board, s1.current, ts.opponent_net))
            rows += B
            played += int((s2.board != s1.board).flatten(0, 1).any(0).sum())
            env = bc.autoreset_planes(s2)
            if config.learner_player != 0:
                need = env.current != seat
                s4 = bc.step_trusted(env, opponent_fn(gen, env.board, env.current,
                                                      ts.opponent_net))
                kept = bc.PlanesState(*(dqn._sel(need, x4, x3) for x4, x3 in zip(s4, env)))
                rows += B
                played += int((kept.board != env.board).flatten(0, 1).any(0).sum())
                env = kept
    return env, rows, played


@pytest.mark.parametrize("learner_player", [0, "both"])
def test_iteration_spans_and_counters(tmp_path, learner_player):
    """Under ``profiling.trace`` one iteration records its root, each phase
    once, an actor and an engine span a ply, the opponent once or twice a
    ply, the updates' spans, and the opponent's counters as a replay of the
    same seeded steps recounts them; the Chrome trace names every span."""
    config = tiny_config(learner_player=learner_player)
    B, L, U = config.num_envs, config.segment_len + config.n_step - 1, config.update_per_collect
    calls = 2 if learner_player == "both" else 1
    gen, ts, iteration, _, env, buf = setup(config)
    with profiling.trace(str(tmp_path)):
        env, buf, loss = iteration(ts, env, buf, gen)
    table = profiling.span_table()
    spans = table["spans"]
    assert table["roots"] == 1
    expect = {"dqn.iteration": 1, **dict.fromkeys(PHASES, 1), "dqn.actor": L, "dqn.engine": L,
              "dqn.opponent": calls * L, "dqn.update": U, "dqn.update.forward": U,
              "dqn.update.backward": U, "dqn.update.step": U}
    assert {k: v["calls"] for k, v in spans.items()} == expect
    assert all(v["roots"] == 1 and v["stream_ms"] is None for v in spans.values())
    iteration_ms = spans["dqn.iteration"]["host_ms"]
    assert sum(spans[p]["host_ms"] for p in PHASES) <= iteration_ms
    assert spans["dqn.opponent"]["host_ms"] <= spans["dqn.engine"]["host_ms"]
    assert spans["dqn.actor"]["host_ms"] + spans["dqn.engine"]["host_ms"] \
        <= spans["dqn.collect"]["host_ms"]

    env_r, rows, played = replayed_counts(config)
    for a, b in zip(env, env_r):
        assert torch.equal(a, b)       # the replay followed the iteration's draws
    assert rows == calls * L * B
    # the actor's exploration draw a ply and each opponent call, on the CPU
    assert table["counters"] == {"dqn.opponent_rows": rows, "dqn.opponent_rows_played": played,
                                 "draw.plain_rows": L * B + rows}
    assert 0 < played < rows

    (path,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(expect) <= names


def test_init_and_evaluate_record_the_opponent():
    """The opponent's span sits in the function ``make_opponent_fn``
    returns, so the env bootstrap and the evaluation record it too, each
    call a root of its own there."""
    config = tiny_config(learner_player=1)
    gen = torch.Generator().manual_seed(SEED)
    ts = dqn.init_train_state(config, dqn.make_net(config, CPU), gen)
    opponent_fn = dqn.make_opponent_fn(config)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dqn.init_env_state(config, opponent_fn, ts.opponent_net, gen)
        dqn.make_eval_fn(config, opponent_fn)(ts.net, ts.opponent_net, gen, num_steps=3,
                                              num_envs=8)
    table = profiling.span_table()
    assert table["roots"] == 4
    assert {k: (v["calls"], v["roots"]) for k, v in table["spans"].items()} == \
        {"dqn.opponent": (4, 4)}
    # the random opponent's draws: the bootstrap's 16 rows and 3 of 8; the
    # evaluation's own draws run outside any span
    assert table["counters"] == {"draw.plain_rows": 16 + 3 * 8}


def test_zoo_move_spans():
    """A host agent move records ``zoo.move`` with its four children, in
    order and inside it, each move a root."""
    agent = zoo.host_agent("dqn_greedy", device="cpu")
    moves = positions(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        actions = [agent.compute_action(obs, mask) for obs, mask in moves]
    assert all(mask[a] == 1 for a, (_, mask) in zip(actions, moves))
    table = profiling.span_table()
    assert table["roots"] == 3
    assert list(table["spans"]) == MOVE
    assert all(v["calls"] == 3 and v["roots"] == 3 for v in table["spans"].values())
    by_root = np.array([table["spans"][n]["host_ms_by_root"] for n in MOVE])
    assert (by_root[1:].sum(0) <= by_root[0]).all()
    events = sorted((e for e in prof.events() if e.name in MOVE),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == MOVE * 3
    for k in range(3):
        move, *children = events[5 * k:5 * k + 5]
        assert move.time_range.start <= children[0].time_range.start
        assert children[-1].time_range.end <= move.time_range.end
        assert all(a.time_range.end <= b.time_range.start
                   for a, b in zip(children, children[1:]))


class Stream:
    """Stand-in for the card's stream: events stamp its clock ``t`` when
    recorded, and the card has passed them once ``passed`` is set."""

    def __init__(self):
        self.t, self.passed = 0.0, False

    def event(self, enable_timing=True):
        stream = self

        class Event:
            def record(self, on):
                assert on is stream
                self.t = stream.t

            def query(self):
                return stream.passed

            def elapsed_time(self, end):
                return end.t - self.t

        return Event()


@pytest.fixture
def stream(monkeypatch):
    s = Stream()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: s)
    monkeypatch.setattr(torch.cuda, "Event", s.event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return s


def spanned_root(stream, start):
    """A root of ``start`` + [0, 10) on the stream holding two ``kid`` spans
    of 3 and 1 ms, the first holding a ``grandkid`` of 2 ms."""
    stream.t = start
    with profiling.annotate("root"):
        stream.t = start + 1
        with profiling.annotate("kid"):
            stream.t = start + 2
            with profiling.annotate("grandkid"):
                stream.t = start + 4
            stream.t = start + 4
        stream.t = start + 5
        with profiling.annotate("kid"):
            stream.t = start + 6
        stream.t = start + 10


def test_stream_times_and_the_fold(stream):
    """Stream ms and self ms from each span's event pair; a closed root
    waits until the card has passed its events, then folds into the totals
    and drops its spans; reading the table folds what is left."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        spanned_root(stream, 0)
        assert len(profiling.TABLE._pending) == 1     # the card is behind
        stream.passed = True
        spanned_root(stream, 20)
        assert profiling.TABLE._pending == []         # both folded at the second's close
        stream.passed = False
        spanned_root(stream, 40)
    assert len(profiling.TABLE._pending) == 1
    table = profiling.span_table()
    assert profiling.TABLE._pending == []
    got = {k: (v["calls"], v["roots"], v["stream_ms"], v["stream_self_ms"])
           for k, v in table["spans"].items()}
    assert got == {"root": (3, 3, 30.0, 18.0), "kid": (6, 3, 12.0, 6.0),
                   "grandkid": (3, 3, 6.0, 6.0)}
    assert table["roots"] == 3
    assert len(table["spans"]["kid"]["host_ms_by_root"]) == 3


def test_host_times_leave_out_the_spans_own_bookkeeping(monkeypatch):
    """On a clock that steps 1 us a read, a span's host ms is its interval
    less the time the spans inside it spent on their own entry and exit,
    so siblings add up to their parent where nothing runs between them."""
    clock = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("root"):            # reads 0 (in), 1000 (t0)
            with profiling.annotate("kid"):         # 2000, 3000 | 4000 (t1), 5000 (out)
                pass
            with profiling.annotate("kid"):         # 6000, 7000 | 8000, 9000
                pass                                # root t1: 10000
    spans = profiling.span_table()["spans"]
    assert spans["kid"]["host_ms_by_root"] == [pytest.approx(0.002)]
    # 10000 - 1000 - 2 * (1000 in + 1000 out)
    assert spans["root"]["host_ms"] == pytest.approx(0.005)


def test_counts_sum_on_the_device_until_read():
    """A tensor count stays a tensor in the open root (no read on the hot
    path); numbers and tensors add up; a count with no span open is
    dropped."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("root"):
            profiling.count("rows", 4)
            profiling.count("rows", torch.tensor(5))
            with profiling.annotate("kid"):
                profiling.count("rows", torch.tensor([True, False, True]).sum())
            held = profiling.TABLE._stack()[0].root.counters["rows"]
            assert isinstance(held, torch.Tensor) and int(held) == 11
        profiling.count("loose", torch.tensor(2))
    assert profiling.span_table()["counters"] == {"rows": 11.0}


def test_trace_empties_the_table(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("before"):
            pass
    assert profiling.span_table()["roots"] == 1
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("inside"):
            pass
    assert list(profiling.span_table()["spans"]) == ["inside"]
