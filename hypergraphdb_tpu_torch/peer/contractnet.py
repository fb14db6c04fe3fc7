"""Contract-net conversations — the ``ProposalConversation`` analogue.

The reference's workflow package ships a FIPA contract-net conversation
(``peer/workflow/ProposalConversation``, used with ``Conversation`` FSMs):
an initiator calls for proposals, participants bid (PROPOSE) or REFUSE,
the initiator accepts exactly one bid and rejects the rest, and the
accepted participant performs the task and reports the result. This module
re-expresses that protocol on the activity framework's ``@from_state``
FSM machinery (``peer/activity.py``) over any transport.

Usage::

    # participant side (each peer that can serve tasks):
    class Worker(TaskParticipant):
        def bid(self, task):      # None → REFUSE
            return {"cost": my_cost(task)}
        def perform(self, task):
            return do_work(task)
    peer.activities.register_type(
        ContractNet.TYPE, lambda peer, activity_id=None:
        Worker(peer, activity_id=activity_id))

    # initiator side:
    act = peer.activities.initiate(ContractNet(
        peer, task={"op": "count"}, participants=[p1, p2, p3]))
    winner, result = act.future.result(timeout=10)
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from hypergraphdb_tpu_torch.peer import messages as M
from hypergraphdb_tpu_torch.peer.activity import (
    STARTED,
    Activity,
    from_state,
)

WAITING_PROPOSALS = "WaitingProposals"
WAITING_RESULT = "WaitingResult"
PROPOSED = "Proposed"


def lowest_cost(bids: dict[str, Any]):
    """Default bid selector: minimal ``cost`` field (ties → peer id)."""
    return min(
        bids,
        key=lambda pid: (
            (bids[pid] or {}).get("cost", float("inf")), pid
        ),
    )


class ContractNet(Activity):
    """Initiator: call for proposals → collect bids → accept one →
    await the winner's result. ``future`` resolves to ``(winner_id,
    result)``; it fails if every participant refuses or the winner
    reports FAILURE."""

    TYPE = "contract-net"

    def __init__(self, peer, task: Any, participants: list[str],
                 select: Optional[Callable[[dict], str]] = None,
                 activity_id: Optional[str] = None):
        super().__init__(peer, activity_id)
        self.task = task
        self.participants = list(participants)
        self.select = select or lowest_cost
        self.bids: dict[str, Any] = {}
        self.refusals: set[str] = set()
        self.winner: Optional[str] = None

    def initiate(self) -> None:
        if not self.participants:
            self.fail("no participants to call for proposals")
            return
        self.state = WAITING_PROPOSALS
        for pid in self.participants:
            self.send(pid, M.REQUEST, {"what": "cfp", "task": self.task})

    def _maybe_decide(self) -> None:
        if len(self.bids) + len(self.refusals) < len(self.participants):
            return
        if not self.bids:
            self.fail("all participants refused the call for proposals")
            return
        self.winner = self.select(self.bids)
        for pid in self.bids:
            if pid == self.winner:
                self.send(pid, M.ACCEPT_PROPOSAL, {"task": self.task})
            else:
                self.send(pid, M.REJECT_PROPOSAL, None)
        self.state = WAITING_RESULT

    @from_state(WAITING_PROPOSALS, M.PROPOSE)
    def on_propose(self, sender: str, msg: dict) -> None:
        # only invited participants count, and a peer answers ONCE — a
        # stray or duplicate reply must not trip the decision threshold
        # early and strand a real bidder in PROPOSED forever
        if sender not in self.participants or sender in self.refusals:
            return
        self.bids[sender] = msg.get("content")
        self._maybe_decide()

    @from_state(WAITING_PROPOSALS, M.REFUSE)
    def on_refuse(self, sender: str, msg: dict) -> None:
        if sender not in self.participants or sender in self.bids:
            return
        self.refusals.add(sender)
        self._maybe_decide()

    @from_state(WAITING_RESULT, M.INFORM)
    def on_result(self, sender: str, msg: dict) -> None:
        if sender == self.winner:
            self.complete((sender, msg.get("content")))

    @from_state(WAITING_RESULT, M.FAILURE)
    def on_failure(self, sender: str, msg: dict) -> None:
        if sender == self.winner:
            self.fail(f"winner {sender} failed: {msg.get('content')}")

    # late bids/refusals after the decision are protocol noise, not errors
    @from_state(WAITING_RESULT, M.PROPOSE)
    def on_late_propose(self, sender: str, msg: dict) -> None:
        if sender in self.participants and sender not in self.bids:
            self.send(sender, M.REJECT_PROPOSAL, None)

    @from_state(WAITING_RESULT, M.REFUSE)
    def on_late_refuse(self, sender: str, msg: dict) -> None:
        pass


class TaskParticipant(Activity):
    """Participant FSM: bid on a CFP, then perform if accepted. Subclasses
    implement :meth:`bid` (return None to refuse) and :meth:`perform`."""

    TYPE = ContractNet.TYPE

    def bid(self, task: Any) -> Optional[dict]:  # pragma: no cover - abstract
        return None

    def perform(self, task: Any) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    @from_state(STARTED, M.REQUEST)
    def on_cfp(self, sender: str, msg: dict) -> None:
        content = msg.get("content") or {}
        self.task = content.get("task")
        try:
            offer = self.bid(self.task)
        except Exception:
            import logging

            logging.getLogger("hypergraphdb_tpu_torch.peer").warning(
                "bid() raised; refusing the call for proposals",
                exc_info=True,
            )
            offer = None
        if offer is None:
            self.reply(sender, msg, M.REFUSE)
            self.complete(None)
        else:
            self.reply(sender, msg, M.PROPOSE, offer)
            self.state = PROPOSED

    @from_state(PROPOSED, M.ACCEPT_PROPOSAL)
    def on_accept(self, sender: str, msg: dict) -> None:
        try:
            result = self.perform(self.task)
        except Exception as e:
            self.reply(sender, msg, M.FAILURE, str(e))
            self.fail(e)
            return
        self.reply(sender, msg, M.INFORM, result)
        self.complete(result)

    @from_state(PROPOSED, M.REJECT_PROPOSAL)
    def on_reject(self, sender: str, msg: dict) -> None:
        self.complete(None)
