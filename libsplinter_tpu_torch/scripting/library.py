"""The built-in stored-script library — the pipeline lane's scenario
programs.

These are the server-side expressions of the loadgen scenarios: each
is a plain Lua chunk taking its working-key prefix (and a sequence
number) through the `arg` table, chaining splinter verbs that the
pipeline lane suspends/resumes as coroutine awaits.  `spt loadgen
--scenario <name>` submits `{"name": "<name>", "args": [...]}`
requests against them — one script request per arrival replaces 3-4
client round trips.

On a downstream typed rejection (a shed search, an expired
completion) the scripts re-raise the BARE typed error string
(`error(err)`): the lane's error classifier recognizes "overloaded" /
"deadline_expired" values and commits the matching typed record, so a
shed deep inside a chain surfaces to the client exactly like a shed
on a direct request.

`seed_library(store)` publishes all of them under their
`__script_<name>` keys (`spt pipeline seed` / the loadgen harness do
this once per store).
"""
from __future__ import annotations

from ..engine import protocol as P

# ingest -> embed -> top-k -> complete, one end-to-end chain — the
# stored-script form of loadgen's client-side rag-churn (args: doc
# key, sequence number, k)
RAG_CHURN = """\
local doc, n, k = arg[1], arg[2] or 0, arg[3] or 4
local ok, err = splinter.submit_embed(
    doc, "churn document " .. n .. " about topic " .. (n % 7))
if not ok then error(err) end
local q = doc .. ":q"
splinter.set(q, "query scratch")
splinter.set_embedding(q, splinter.get_embedding(doc))
local hits, serr = splinter.submit_search(q, k)
splinter.unset(q)
if not hits then error(serr) end
local ctx = table.concat(hits, ", ")
if ctx == "" then ctx = "nothing" end
local out, cerr = splinter.submit_completion(
    doc .. ":c",
    "context: " .. ctx .. "\\nquestion: what is " .. doc ..
    " about?")
if not out then error(cerr) end
splinter.unset(doc .. ":c")
return #hits
"""

# iterative agent: retrieve -> complete -> conditionally retrieve
# again (args: doc key, sequence number, rounds)
AGENT_LOOP = """\
local doc, n, rounds = arg[1], arg[2] or 0, arg[3] or 2
local ok, err = splinter.submit_embed(
    doc, "agent seed " .. n .. " about topic " .. (n % 7))
if not ok then error(err) end
local q = doc .. ":q"
splinter.set(q, "query scratch")
local steps = 0
for r = 1, rounds do
  splinter.set_embedding(q, splinter.get_embedding(doc))
  local hits, serr = splinter.submit_search(q, 3)
  if not hits then splinter.unset(q) error(serr) end
  local out, cerr = splinter.submit_completion(
      doc .. ":c" .. r,
      "step " .. r .. " context: " .. table.concat(hits, ", "))
  if not out then splinter.unset(q) error(cerr) end
  splinter.unset(doc .. ":c" .. r)
  steps = r
  if #hits == 0 then break end
end
splinter.unset(q)
return steps
"""

# two-hop retrieval: search, pivot on the top hit's OWN embedding,
# search again, then complete over the second-hop context (args: doc
# key, sequence number)
MULTI_HOP = """\
local doc, n = arg[1], arg[2] or 0
local ok, err = splinter.submit_embed(
    doc, "hop source " .. n .. " about topic " .. (n % 7))
if not ok then error(err) end
local q = doc .. ":q"
splinter.set(q, "query scratch")
splinter.set_embedding(q, splinter.get_embedding(doc))
local hits, serr = splinter.submit_search(q, 2)
if not hits then splinter.unset(q) error(serr) end
local hop = hits[1]
if hop then
  local hv = splinter.get_embedding(hop)
  if hv then
    splinter.set_embedding(q, hv)
    local hits2, serr2 = splinter.submit_search(q, 2)
    if not hits2 then splinter.unset(q) error(serr2) end
    hits = hits2
  end
end
splinter.unset(q)
local out, cerr = splinter.submit_completion(
    doc .. ":c", "hops: " .. table.concat(hits, " -> "))
if not out then error(cerr) end
splinter.unset(doc .. ":c")
return #hits
"""

# fan-out/fan-in summarization: summarize each top hit, then reduce
# the partials in one final completion (args: doc key, sequence
# number, fan width)
MAP_REDUCE = """\
local doc, n, fan = arg[1], arg[2] or 0, arg[3] or 3
local ok, err = splinter.submit_embed(
    doc, "mapreduce seed " .. n .. " about topic " .. (n % 7))
if not ok then error(err) end
local q = doc .. ":q"
splinter.set(q, "query scratch")
splinter.set_embedding(q, splinter.get_embedding(doc))
local hits, serr = splinter.submit_search(q, fan)
splinter.unset(q)
if not hits then error(serr) end
local parts = {}
for i = 1, #hits do
  local s, merr = splinter.submit_completion(
      doc .. ":m" .. i, "summarize: " .. hits[i])
  if not s then error(merr) end
  splinter.unset(doc .. ":m" .. i)
  parts[i] = s
end
local out, rerr = splinter.submit_completion(
    doc .. ":r", "combine: " .. table.concat(parts, " | "))
if not out then error(rerr) end
splinter.unset(doc .. ":r")
return #parts
"""

SCRIPT_LIBRARY: dict[str, str] = {
    "rag-churn": RAG_CHURN,
    "agent-loop": AGENT_LOOP,
    "multi-hop": MULTI_HOP,
    "map-reduce": MAP_REDUCE,
}


def seed_library(store, names=None) -> list[str]:
    """Store the built-in scripts under their __script_<name> keys.
    Returns the seeded names (idempotent — re-seeding overwrites)."""
    out = []
    for name in (names or SCRIPT_LIBRARY):
        store.set(P.stored_script_key(name), SCRIPT_LIBRARY[name])
        out.append(name)
    return out
