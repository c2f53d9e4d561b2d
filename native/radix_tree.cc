// Native radix prefix cache + KV block pool.
//
// C++ implementation of the host-side serving hot path: the token-level radix
// tree (prefix matching on every request admission — Python equivalent in
// physics_llm_inference/runtime/radix_cache.py, capability parity with
// the reference's ch07/radix_cache.py plus refcounts and LRU eviction) and
// the paged-KV block pool (ch07/paged_memory.py equivalent). Exposed through
// a C ABI consumed via ctypes (no pybind11 in the image).
//
// Build: `make` in this directory → libpli_native.so.

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

namespace {

struct Node {
  std::vector<int64_t> tokens;
  std::vector<int64_t> kv;
  std::map<int64_t, std::unique_ptr<Node>> children;
  Node* parent = nullptr;
  int ref_count = 0;
  uint64_t last_access = 0;

  bool is_leaf() const { return children.empty(); }
};

struct RadixTree {
  Node root;
  uint64_t clock = 0;
  int64_t hits = 0;
  int64_t lookups = 0;

  void touch(Node* n) { n->last_access = ++clock; }
};

struct BlockPool {
  int64_t num_blocks;
  int64_t block_size;
  std::vector<int64_t> free_list;               // stack of free ids
  std::vector<int32_t> ref_counts;              // per block

  explicit BlockPool(int64_t n, int64_t bs) : num_blocks(n), block_size(bs),
                                              ref_counts(n, 0) {
    free_list.reserve(n);
    for (int64_t i = n - 1; i >= 0; --i) free_list.push_back(i);
  }
};

// Walk helper: returns (node, tokens_matched); positions the caller at the
// deepest fully-matched node and reports partial-edge matches.
int64_t walk(RadixTree* t, const int64_t* tokens, int64_t n,
             std::vector<Node*>* path, std::vector<int64_t>* kv_out,
             bool touch) {
  Node* node = &t->root;
  int64_t i = 0;
  while (i < n) {
    auto it = node->children.find(tokens[i]);
    if (it == node->children.end()) break;
    Node* nxt = it->second.get();
    int64_t m = 0;
    while (m < (int64_t)nxt->tokens.size() && i + m < n &&
           nxt->tokens[m] == tokens[i + m])
      ++m;
    if (kv_out)
      kv_out->insert(kv_out->end(), nxt->kv.begin(), nxt->kv.begin() + m);
    i += m;
    if (m < (int64_t)nxt->tokens.size()) break;
    node = nxt;
    if (touch) t->touch(node);
    if (path) path->push_back(node);
  }
  return i;
}

}  // namespace

extern "C" {

// ----------------------------------------------------------------- radix

void* rt_new() { return new RadixTree(); }
void rt_free(void* h) { delete static_cast<RadixTree*>(h); }

// Insert a sequence with its kv indices; returns number of NEW tokens added.
int64_t rt_insert(void* h, const int64_t* tokens, const int64_t* kv,
                  int64_t n) {
  auto* t = static_cast<RadixTree*>(h);
  Node* node = &t->root;
  int64_t i = 0;
  while (i < n) {
    auto it = node->children.find(tokens[i]);
    if (it == node->children.end()) {
      auto child = std::make_unique<Node>();
      child->tokens.assign(tokens + i, tokens + n);
      child->kv.assign(kv + i, kv + n);
      child->parent = node;
      t->touch(child.get());
      node->children[tokens[i]] = std::move(child);
      return n - i;
    }
    Node* nxt = it->second.get();
    int64_t m = 0;
    while (m < (int64_t)nxt->tokens.size() && i + m < n &&
           nxt->tokens[m] == tokens[i + m])
      ++m;
    if (m < (int64_t)nxt->tokens.size()) {
      // split edge at m
      auto tail = std::make_unique<Node>();
      tail->tokens.assign(nxt->tokens.begin() + m, nxt->tokens.end());
      tail->kv.assign(nxt->kv.begin() + m, nxt->kv.end());
      tail->children = std::move(nxt->children);
      tail->parent = nxt;
      tail->ref_count = nxt->ref_count;
      tail->last_access = nxt->last_access;
      for (auto& c : tail->children) c.second->parent = tail.get();
      nxt->tokens.resize(m);
      nxt->kv.resize(m);
      nxt->children.clear();
      nxt->children[tail->tokens[0]] = std::move(tail);
    }
    node = nxt;
    t->touch(node);
    i += m;
  }
  return 0;
}

// Longest cached prefix. Fills out_kv (caller-sized >= n); returns match len.
// lock=1 increments refcounts along the fully-matched path.
int64_t rt_match(void* h, const int64_t* tokens, int64_t n, int64_t* out_kv,
                 int32_t lock) {
  auto* t = static_cast<RadixTree*>(h);
  ++t->lookups;
  std::vector<Node*> path;
  std::vector<int64_t> kv;
  int64_t i = walk(t, tokens, n, &path, &kv, /*touch=*/true);
  if (i > 0) ++t->hits;
  if (lock)
    for (Node* nd : path) ++nd->ref_count;
  if (out_kv) std::memcpy(out_kv, kv.data(), kv.size() * sizeof(int64_t));
  return i;
}

// Decrement refcounts taken by a locked match.
void rt_unlock(void* h, const int64_t* tokens, int64_t n) {
  auto* t = static_cast<RadixTree*>(h);
  std::vector<Node*> path;
  walk(t, tokens, n, &path, nullptr, /*touch=*/false);
  for (Node* nd : path)
    if (nd->ref_count > 0) --nd->ref_count;
}

// Evict LRU unreferenced leaves until >= num_tokens kv indices are freed or
// nothing evictable remains. Fills out_kv up to cap; returns count freed.
int64_t rt_evict(void* h, int64_t num_tokens, int64_t* out_kv, int64_t cap) {
  auto* t = static_cast<RadixTree*>(h);
  int64_t freed = 0;
  while (freed < num_tokens) {
    // find LRU unreferenced leaf
    Node* victim = nullptr;
    std::vector<Node*> stack{&t->root};
    while (!stack.empty()) {
      Node* nd = stack.back();
      stack.pop_back();
      for (auto& c : nd->children) stack.push_back(c.second.get());
      if (nd != &t->root && nd->is_leaf() && nd->ref_count == 0 &&
          (!victim || nd->last_access < victim->last_access))
        victim = nd;
    }
    if (!victim) break;
    for (int64_t kvi : victim->kv) {
      if (freed < cap) out_kv[freed] = kvi;
      ++freed;
    }
    Node* parent = victim->parent;
    parent->children.erase(victim->tokens[0]);
  }
  return freed < cap ? freed : cap;
}

int64_t rt_cached_tokens(void* h) {
  auto* t = static_cast<RadixTree*>(h);
  int64_t total = 0;
  std::vector<Node*> stack{&t->root};
  while (!stack.empty()) {
    Node* nd = stack.back();
    stack.pop_back();
    total += nd->tokens.size();
    for (auto& c : nd->children) stack.push_back(c.second.get());
  }
  return total;
}

int64_t rt_hits(void* h) { return static_cast<RadixTree*>(h)->hits; }
int64_t rt_lookups(void* h) { return static_cast<RadixTree*>(h)->lookups; }

// ----------------------------------------------------------------- blocks

void* bp_new(int64_t num_blocks, int64_t block_size) {
  return new BlockPool(num_blocks, block_size);
}
void bp_free(void* h) { delete static_cast<BlockPool*>(h); }

int64_t bp_free_blocks(void* h) {
  return static_cast<BlockPool*>(h)->free_list.size();
}

// Allocate n blocks; fills out_ids; returns n or -1 if insufficient.
int64_t bp_alloc(void* h, int64_t n, int64_t* out_ids) {
  auto* p = static_cast<BlockPool*>(h);
  if ((int64_t)p->free_list.size() < n) return -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = p->free_list.back();
    p->free_list.pop_back();
    p->ref_counts[b] = 1;
    out_ids[i] = b;
  }
  return n;
}

void bp_ref(void* h, const int64_t* ids, int64_t n) {
  auto* p = static_cast<BlockPool*>(h);
  for (int64_t i = 0; i < n; ++i) ++p->ref_counts[ids[i]];
}

// Decrement refcounts; fully-freed blocks return to the pool. Returns #freed.
int64_t bp_release(void* h, const int64_t* ids, int64_t n) {
  auto* p = static_cast<BlockPool*>(h);
  int64_t freed = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = ids[i];
    if (p->ref_counts[b] > 0 && --p->ref_counts[b] == 0) {
      p->free_list.push_back(b);
      ++freed;
    }
  }
  return freed;
}

}  // extern "C"
