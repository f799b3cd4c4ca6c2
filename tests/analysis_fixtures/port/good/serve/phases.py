"""Positive fixture: every declared writer assigning its declared phases
(the port's table, with the prefix-cache ``match`` phase)."""


class Scheduler:
    def admit_next(self, st, swapped, hit):
        if hit:
            st.phase = "match"
        elif swapped:
            st.phase = "restore"
        else:
            st.phase = "prefill"

    def to_ready(self, st):
        st.phase = "ready"

    def preempt_batch(self, st):
        st.phase = "waiting"


class ServeEngine:
    def _fill_lanes(self, st):
        st.phase = "running"

    def _retire(self, st):
        st.phase = "done"
